"""The port's tracer (``rise_sdf_tpu_torch/trace.py``) on the CPU at the
tiny sizes: off it records nothing and reads no clock; on, a NeuS train
step and a flagship eval chunk give their stages' span trees, the K1
byte counter follows the byte rule, the device counters read what the
sample buffer kept, and the spans share the profiler's clock."""

import time

import pytest
import torch

from rise_sdf_tpu_torch import datasets, models, presets, systems, trace
from rise_sdf_tpu_torch.bench import image_rays, solid_occupancy, \
    tiny_bench_config
from rise_sdf_tpu_torch.ops.scatter import scatter_add


@pytest.fixture(scope="module")
def neus(tmp_path_factory):
    cfg = presets.tiny_neus_config()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=str(tmp_path_factory.mktemp("trace")),
                          device="cpu")
    state = system.init_state(0)
    data = system.device_data(dm.train())
    return system, state, data


def _train_step(neus):
    """One step as ``fit`` takes it: a sweep, a batch, the update."""
    system, state, data = neus
    gen = torch.Generator().manual_seed(int(state["step"]))
    system.update_occupancy(state, gen)
    batch = system.sample_batch(gen, data)
    return system.train_step(state, batch, gen)


@pytest.fixture(scope="module")
def flagship():
    """The tiny flagship with the bench's eval options and one chunk's
    inputs."""
    mcfg = tiny_bench_config()["model"]
    model = models.make(mcfg["name"], mcfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    step = int(mcfg["split_sum_kick_in_step"]) + 1
    chunk = int(mcfg["ray_chunk"])
    kw = dict(occ_binary=solid_occupancy(model, "cpu"), step=step,
              background_color=torch.ones(3),
              **model.eval_options(step, chunk))
    return model, image_rays(16, "cpu")[:chunk], kw


def _eval_chunk(flagship):
    model, rays, kw = flagship
    with torch.no_grad():
        mips = model.emitter.build_mips()
        bake = model.bake_eval_sdf(kw["step"])
        return model(rays, mips=mips, bake=bake, **kw)


def _tree(rec):
    """{span name: set of its parents' names} and the spans by id."""
    by_id = {s.id: s for s in rec.spans}
    parents = {}
    for s in rec.spans:
        parents.setdefault(s.name, set()).add(
            None if s.parent is None else by_id[s.parent].name)
    return parents, by_id


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_off_records_nothing(neus, flagship, monkeypatch):
    assert trace.span("model.march") is trace.NO_SPAN
    assert trace.span("kernel.k1") is trace.span("train.step")
    assert not trace.on()

    def refuse(*args, **kw):
        raise AssertionError("the tracer is off")

    # off, no site may open a span, add to a counter or read the clock
    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(trace.Record, "count", refuse)
    monkeypatch.setattr(trace, "time", None)
    _train_step(neus)
    _eval_chunk(flagship)


def test_train_step_span_tree(neus):
    with trace.recording() as rec:
        aux = _train_step(neus)
    parents, by_id = _tree(rec)
    assert parents["train.occupancy"] == {None}
    assert parents["train.sample_batch"] == {None}
    assert parents["train.step"] == {None}
    for name in ("train.forward", "train.backward", "train.guard",
                 "train.optimizer"):
        assert parents[name] == {"train.step"}, name
    assert "train.allreduce" not in parents  # one process, no ranks
    assert parents["model.forward"] == {"train.forward"}
    for name in ("model.march", "model.geometry", "model.texture",
                 "model.weights", "model.accumulate"):
        assert parents[name] == {"model.forward"}, name
    # the hash encode's gathers in the forward and the sweep, its
    # table-gradient scatters in the backward
    assert "model.geometry" in parents["kernel.g1"]
    assert {by_id[s.root].name for s in rec.spans
            if s.name == "kernel.g1"} == {"train.occupancy", "train.step"}
    k1 = [s for s in rec.spans if s.name == "kernel.k1"]
    assert k1 and all(by_id[s.root].name == "train.step" for s in k1)
    assert all(_inside(s, by_id[s.parent]) for s in rec.spans
               if s.parent is not None)
    step = next(s for s in rec.spans if s.name == "train.step")
    assert all(s.root == step.id for s in rec.spans
               if s.name.startswith(("train.forward", "model.")))
    # one value a forward
    assert rec.counts["model.rays_included"] == [int(aux["num_rays"])]


def test_allreduce_span_over_ranks(neus, monkeypatch):
    """Over ranks the gradients' all-reduce is a stage of the step,
    between the backward and the guard."""
    from rise_sdf_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "world_size", lambda: 2)
    with trace.recording() as rec:
        _train_step(neus)
    parents, _ = _tree(rec)
    assert parents["train.allreduce"] == {"train.step"}
    order = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)
             if s.parent is not None and parents[s.name] == {"train.step"}]
    assert order == ["train.forward", "train.backward", "train.allreduce",
                     "train.guard", "train.optimizer"]


def test_eval_chunk_span_tree(flagship):
    with trace.recording() as rec:
        out = _eval_chunk(flagship)
    parents, by_id = _tree(rec)
    assert parents["eval.build_mips"] == {None}
    assert parents["eval.bake"] == {None}
    assert parents["model.forward"] == {None}
    for name in ("model.visibility", "model.march", "model.geometry",
                 "model.weights", "model.compact", "model.texture",
                 "model.accumulate", "model.secondary"):
        assert parents[name] == {"model.forward"}, name
    forward = next(s for s in rec.spans if s.name == "model.forward")
    assert all(s.root == forward.id for s in rec.spans
               if s.start_ns >= forward.start_ns
               and s.end_ns <= forward.end_ns)
    assert "kernel.k1" not in parents  # no backward in an eval
    # the baked-SDF samples: G1 under the probe, the march's geometry
    # and the secondary pass
    assert {by_id[s.parent].name for s in rec.spans
            if s.name == "kernel.g1"} >= {"model.visibility",
                                          "model.secondary"}
    _, _, kw = flagship
    shaded_most = max(int(kw["capacity"] * 0.5), 16)
    assert rec.counts["model.rays_included"] == \
        [int(out["ray_included"].sum())]
    assert rec.counts["model.samples_kept"] == \
        [min(int(out["stat_live"]), kw["capacity"])]
    assert rec.counts["model.samples_shaded"] == \
        [min(int(out["stat_vis"]), shaded_most)]


@pytest.mark.parametrize("rows,features,table", [(1000, 2, 4096),
                                                 (0, 2, 64), (7, 8, 5)])
def test_k1_bytes_follow_the_byte_rule(rows, features, table):
    gen = torch.Generator().manual_seed(rows)
    idx = torch.randint(0, table, (rows,), generator=gen,
                        dtype=torch.int32)
    vals = torch.rand((rows, features), generator=gen)
    with trace.recording() as rec:
        scatter_add(idx, vals, table)
        scatter_add(idx, vals, table, period=1)
    # each index and value read once, the [T, F] table written once
    want = rows * 4 + rows * features * 4 + table * features * 4
    assert rec.counts["kernel.k1.bytes"] == [want, want]
    assert [s.name for s in rec.spans] == ["kernel.k1", "kernel.k1"]


def test_samples_kept_is_what_the_buffer_kept(neus):
    system, state, data = neus
    gen = torch.Generator().manual_seed(5)
    batch = system.sample_batch(gen, data)
    kept = []
    for capacity in (system.capacity, 64):
        with trace.recording() as rec, torch.no_grad():
            out = system.model(batch["rays"],
                               occ_binary=state["occ_binary"],
                               step=int(state["step"]), capacity=capacity,
                               background_color=batch["bg"])
        live = int(out["num_samples"])
        assert rec.counts["model.samples_kept"] == [min(live, capacity)]
        assert rec.counts["model.samples_shaded"] == [min(live, capacity)]
        kept.append((live, rec.counts["model.samples_kept"][0]))
    # the small buffer overflows: the march's count exceeds what it kept
    live, small = kept[1]
    assert small == 64 < live


def test_host_and_device_counts_mix():
    with trace.recording() as rec:
        trace.count("a", 3)
        trace.count("a", torch.tensor([True, False, True]))
        trace.count("a", torch.tensor(10), most=4)
        trace.count("b", 7, most=5)
    assert rec.counts == {"a": [3, 2, 4], "b": [5]}
    with pytest.raises(RuntimeError):
        with trace.recording(), trace.recording():
            pass
    assert not trace.on()


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("outer"):
                with record_function("inside"):
                    torch.ones(64).sum()
                    time.sleep(0.005)
    (span,) = rec.spans
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "inside"]
    start, end = event.start_ns(), event.start_ns() + event.duration_ns()
    ms = 1_000_000
    assert span.start_ns - ms <= start <= span.start_ns + ms
    assert span.end_ns - ms <= end <= span.end_ns + ms
