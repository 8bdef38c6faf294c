"""Port parity: the eval render's overflow escalation against the JAX
package's, on the CPU, at a capacity that drops rays even at 4x.

``tiny_split_config`` (stage 1, step 20, variance 0.3, a solid occupancy
grid within 1.0 of the centre: the protocol state of
``tests/test_torch_test_protocol.py``) with ``eval_samples_per_ray`` cut
from 32 to 5 and to 4, the knob both systems read for the eval buffer
(``ray_chunk * eval_samples_per_ray`` samples per chunk of 256 rays).
Every chunk of test view 0 overflows at 1x and at 2x and re-renders at
4x on both sides; at 5 samples per ray 43 rays of 1,024 still overflow
the 4x buffer, at 4 samples 198.  Both sides drop the same rays, and
the rays both include agree to 1e-3 in colour, physically based colour,
opacity and depth, the bound ``tests/test_torch_test_protocol.py``
holds the test protocol's renders to (measured: 1.2e-4 at most, in the
physically based colour of 3 of 2,943 entries; the float32 scan over
this soft field, as ``tests/test_torch_neus.py`` describes).
"""

import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.presets import tiny_split_config as jtiny
from rise_sdf_tpu_torch import bridge, datasets, presets, systems

STEP, VARIANCE = 20, 0.3
KEYS = ("comp_rgb_full", "comp_rgb_phys_full", "opacity", "depth")


def _solid(res, radius=1.0):
    g = (np.arange(res) + 0.5) / res * 3.0 - 1.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) < radius).reshape(-1)


@pytest.mark.parametrize("spr,dropped", [(5, 43), (4, 198)])
def test_escalation_drops_the_rays_jax_drops(tmp_path, spr, dropped):
    jcfg = jtiny()
    jcfg["model"]["variance"]["init_val"] = VARIANCE
    jcfg["model"]["eval_samples_per_ray"] = spr
    jdm = jdatasets.make(jcfg.dataset.name, jcfg.dataset)
    jsys = jsystems.make(jcfg.system.name, jcfg, jdm,
                         save_dir=str(tmp_path / "jax"))
    jstate = jsys.init_state(0)
    res = jsys.model.grid_resolution
    jstate["step"] = np.int32(STEP)
    jstate["occ_binary"] = _solid(res)
    jmults = []
    make_fallback = jsys._make_fallback_chunk

    def record(render_chunk, mult=2):
        jmults.append(mult)
        return make_fallback(render_chunk, mult)

    jsys._make_fallback_chunk = record
    want = jsys.render_image(jstate, jdm.test(), 0)

    cfg = presets.tiny_split_config()
    cfg["model"]["variance"]["init_val"] = VARIANCE
    cfg["model"]["eval_samples_per_ray"] = spr
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=str(tmp_path / "port"), device="cpu")
    system.model.load_state_dict(bridge.from_jax_params(
        bridge.flatten_params(jstate["params"])), strict=True)
    state = {"step": STEP, "occs": torch.zeros(res ** 3),
             "occ_binary": torch.from_numpy(_solid(res))}
    mults, render_chunk = [], system.render_chunk

    def spy(state_, rays, mult=1, **kw):
        mults.append(mult)
        return render_chunk(state_, rays, mult, **kw)

    system.render_chunk = spy
    got = system.render_image(state, dm.test(), 0)

    n_chunks = 1024 // system.eval_chunk
    assert mults == [1, 2, 4] * n_chunks
    assert sorted(set(jmults)) == [2, 4]  # built once each, then cached
    inc, jinc = got["ray_included"], np.asarray(want["ray_included"])
    assert int((~jinc).sum()) == int((~inc).sum()) == dropped
    np.testing.assert_array_equal(inc, jinc)
    for k in KEYS:
        np.testing.assert_allclose(got[k][inc], np.asarray(want[k])[inc],
                                   rtol=0, atol=1e-3, err_msg=k)
