"""``correct`` on the CPU at the tiny sizes: the reference agrees with
the port, and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have."""

import pytest
import torch

from benchmarks import common, run
from benchmarks.reference import models as ref_models

SEED = 2_718_281_828


@pytest.mark.parametrize("config", ["tiny_neus_config", "tiny_split_config",
                                    "tiny_bench_config"])
def test_reference_forward_matches_the_port(config):
    from rise_sdf_tpu_torch import models, presets
    from rise_sdf_tpu_torch.bench import tiny_bench_config, image_rays

    cfg = tiny_bench_config() if config == "tiny_bench_config" \
        else getattr(presets, config)()
    mcfg = cfg["model"]
    ref = common.reference_weights(ref_models, mcfg, SEED, "cpu")
    prog = models.make(mcfg["name"], mcfg)
    prog.load_state_dict(ref.state_dict())
    rays = image_rays(8, "cpu")
    occ = torch.ones(prog.grid_resolution ** 3, dtype=torch.bool)
    step = int(mcfg.get("split_sum_kick_in_step", 0)) + 1
    kw = dict(occ_binary=occ, step=step, train=False, capacity=64 * 64,
              background_color=torch.ones(3))
    if "split" in mcfg["name"]:
        kw = dict(occ_binary=occ, step=step,
                  background_color=torch.ones(3),
                  **prog.eval_options(step, 64))
        with torch.no_grad():
            a = prog(rays, mips=prog.emitter.build_mips(),
                     bake=prog.bake_eval_sdf(step), **kw)
            b = ref(rays, mips=ref.emitter.build_mips(),
                    bake=ref.bake_eval_sdf(step), **kw)
    else:
        a, b = prog(rays, **kw), ref(rays, **kw)
    assert torch.equal(a["ray_included"], b["ray_included"])
    assert torch.allclose(a["comp_rgb_full"], b["comp_rgb_full"],
                          atol=1e-6, rtol=0)


def _no_update(orig):
    def train_step(self, state, batch, generator=None, **kw):
        keep = [p.detach().clone() for p in self.model.parameters()]
        aux = orig(self, state, batch, generator, **kw)
        with torch.no_grad():
            for p, k in zip(self.model.parameters(), keep):
                p.copy_(k)
        return aux
    return train_step


def _half_batch(orig):
    def forward_loss(self, batch, *args, **kw):
        n = batch["rays"].shape[0] // 2
        half = {k: (v[:n] if v.dim() and v.shape[0] == 2 * n else v)
                for k, v in batch.items()}
        return orig(self, half, *args, **kw)
    return forward_loss


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch"])
@pytest.mark.parametrize("workload", ["neus-blender.train",
                                      "split-mixed-occ-tensoir.train-s1-det"])
def test_train_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    from rise_sdf_tpu_torch.systems.neus import NeuSSystem
    from rise_sdf_tpu_torch.systems.split_occ import SplitOccSystem

    cls = SplitOccSystem if "split" in workload else NeuSSystem
    if fault == "state unchanged":
        monkeypatch.setattr(cls, "train_step", _no_update(cls.train_step))
    else:
        monkeypatch.setattr(cls, "forward_loss",
                            _half_batch(cls.forward_loss))
    out = run.run_cell(workload, SEED, 0.2, False, device="cpu",
                       root=tiny_root)
    assert out["correct"] is False


def test_render_answer_altered_is_not_correct(tiny_root, monkeypatch):
    from rise_sdf_tpu_torch.models.split_mixed_occ import SplitMixedOccModel

    orig = SplitMixedOccModel.forward

    def forward(self, rays, **kw):
        out = orig(self, rays, **kw)
        out["comp_rgb_full"] = out["comp_rgb_full"].clone()
        out["comp_rgb_full"][0, 0] += 0.25
        return out

    monkeypatch.setattr(SplitMixedOccModel, "forward", forward)
    out = run.run_cell("split-mixed-occ-tensoir.render", SEED, 0.2, False,
                       device="cpu", root=tiny_root)
    assert out["correct"] is False
    assert out["checks"]["rgb_gap"]["value"] == pytest.approx(0.25,
                                                              rel=1e-3)
