"""The attribution of a traced stretch to the program's stages
(``yardstick/spans.py``) on event tuples made by hand, the stretch with
the program's tracer on (``stages.py``) at the tiny sizes, and the
readers of the metrics that read it."""

import pytest

from benchmarks import cells, render, stages, train
from benchmarks.yardstick import roofline, spans
from benchmarks.yardstick.peaks import FP32_FLOPS

from .test_bench_harness import SEED

US = 1000  # ns


def _span(name, i, parent, start_us, end_us, root):
    return (name, i, parent, start_us * US, end_us * US, root)


# train.step [0, 100] holding train.forward [10, 40] holding
# model.forward [12, 38] holding kernel.g1 [20, 30]; kernel.k1 [50, 60]
# in train.step; the harness from 100 to 130
SPANS = [_span("kernel.g1", 3, 2, 20, 30, 0),
         _span("model.forward", 2, 1, 12, 38, 0),
         _span("train.forward", 1, 0, 10, 40, 0),
         _span("kernel.k1", 4, 0, 50, 60, 0),
         _span("train.step", 0, None, 0, 100, 0)]


def _events():
    """Runtime calls (host) and the kernels they launched (device)."""
    host = [("cudaLaunchKernel", False, 21.0, 22.0, 1),  # in kernel.g1
            ("cudaLaunchKernel", False, 13.0, 14.0, 2),  # in model.forward
            ("cudaLaunchKernel", False, 50.0, 51.0, 3),  # on k1's edge
            ("cudaLaunchKernel", False, 105.0, 106.0, 4),  # no span
            ("cudaStreamSynchronize", False, 120.0, 130.0, 0)]
    dev = [("g1_kernel", True, 22.0, 32.0, 1),
           ("mlp_kernel", True, 32.0, 45.0, 2),
           ("k1_kernel", True, 52.0, 56.0, 3),
           ("harness_kernel", True, 107.0, 110.0, 4)]
    return host + dev


WINDOW_S = 117e-6  # from the first event (13 us) to the last (130)


def test_kernel_attribution():
    got = {e[0]: (None if s is None else s[0])
           for s, e in spans.kernel_attribution(_events(), SPANS)}
    # by where the launch started, not where the kernel ran
    assert got == {"g1_kernel": "kernel.g1", "mlp_kernel": "model.forward",
                   "k1_kernel": "kernel.k1", "harness_kernel": None}
    by = spans.device_by_name(_events(), SPANS)
    assert by == pytest.approx({"kernel.g1": 10e-6, "model.forward": 13e-6,
                                "kernel.k1": 4e-6, spans.HARNESS: 3e-6})
    rec = {"events": _events(), "spans": SPANS}
    # a stage's device time takes in its children's
    assert spans.device_s(rec, "train.forward") == pytest.approx(23e-6)
    assert spans.device_s(rec, "train.step") == pytest.approx(27e-6)
    assert spans.device_s(rec, "kernel.k1", "kernel.g1") == \
        pytest.approx(14e-6)


def test_idle_attribution():
    # the stretch runs from 13 (the first event) to 130; idle: 13-22
    # (middle 17.5, model.forward), 45-52 (48.5, train.step), 56-107
    # (81.5, train.step), 110-130 (120, no span)
    got = [(None if s is None else s[0], v)
           for s, v in spans.idle_attribution(_events(), SPANS)]
    assert [n for n, _ in got] == ["model.forward", "train.step",
                                   "train.step", None]
    assert [v for _, v in got] == pytest.approx([9e-6, 7e-6, 51e-6, 20e-6])
    assert spans.idle_by_name(_events(), SPANS) == pytest.approx(
        {"model.forward": 9e-6, "train.step": 58e-6, spans.HARNESS: 20e-6})
    rec = {"events": _events(), "spans": SPANS}
    assert spans.idle_s(rec, "train.step") == pytest.approx(67e-6)
    assert spans.idle_s(rec, "train.forward") == pytest.approx(9e-6)
    assert spans.idle_s(rec, "kernel.g1") == 0.0
    assert spans.window_s(rec) == pytest.approx(WINDOW_S)


def test_innermost_on_edges():
    pts = [0.0, 10.0, 12.0, 38.0, 40.0, 100.0, 100.5]
    got = [None if s is None else s[0] for s in spans.innermost(SPANS, pts)]
    assert got == ["train.step", "train.forward", "model.forward",
                   "model.forward", "train.forward", "train.step", None]


def _train_record():
    rec = {"events": _events(), "spans": SPANS,
           "counts": {"kernel.k1.bytes": [3350, 3350]}, "periods": 1,
           "model_flops": 0.5 * FP32_FLOPS * WINDOW_S}
    return {"kind": "train", "program": rec}


def _reader(name):
    return cells.load_reader(cells.HERE / "metrics" / f"{name}.py")


def test_train_readers_by_hand():
    t = _train_record()
    assert _reader("step_idle_ms")(t) == pytest.approx(67e-3)
    assert _reader("k1_counted_roofline_pct")(t) == pytest.approx(
        roofline.share_pct(6700, 4e-6))
    assert _reader("train_mfu_counted_pct")(t) == pytest.approx(50.0)
    assert _reader("occupancy_device_ms")(t) is None  # no sweep in it
    rec = t["program"]
    rec["spans"] = SPANS + [_span("train.occupancy", 5, None, 101, 115, 5)]
    assert _reader("occupancy_device_ms")(t) == pytest.approx(3e-3)
    # a render reader finds nothing in a train record, nor any reader in
    # a record without the stretch
    assert _reader("forward_idle_ms")(t) is None
    for name in ("step_idle_ms", "k1_counted_roofline_pct",
                 "train_mfu_counted_pct", "occupancy_device_ms"):
        assert _reader(name)({"kind": "train"}) is None


def test_render_readers_by_hand():
    names = {"kernel.g1": "eval.bake", "train.step": "model.forward"}
    rec = {"events": _events(),
           "spans": [(names.get(s[0], s[0]),) + s[1:] for s in SPANS],
           "counts": {}, "periods": 1,
           "model_flops": 0.25 * FP32_FLOPS * WINDOW_S}
    t = {"kind": "render", "program": rec}
    assert _reader("forward_idle_ms")(t) == pytest.approx(67e-3)
    assert _reader("bake_mips_device_ms")(t) == pytest.approx(10e-3)
    assert _reader("render_mfu_counted_pct")(t) == pytest.approx(25.0)


@pytest.fixture(scope="module")
def tiny_records(tiny_root):
    """The stretch with the tracer on, after the harness's set-up, in a
    tiny train cell and the tiny render cell on the CPU."""
    here = tiny_root / "benchmarks"
    cell = cells.load("neus-blender.train", root=tiny_root, here=here)
    trainer, _, dims = train.build(cell, SEED, "cpu")
    period = int(cell.traffic["occupancy_every"])
    t_train = stages.train_period(trainer, dims, cell.config["run"], "cpu",
                                  period)
    cell = cells.load("split-mixed-occ-tensoir.render", root=tiny_root,
                      here=here)
    t_render = stages.image(render.build(cell, SEED, "cpu"), "cpu")
    return ({"kind": "train", "program": t_train},
            {"kind": "render", "program": t_render}, period)


def test_tiny_train_stretch(tiny_records):
    t, _, period = tiny_records
    rec = t["program"]
    names = [s[0] for s in rec["spans"]]
    assert names.count("train.step") == period
    assert names.count("train.occupancy") == 1
    kept = rec["counts"]["model.samples_kept"]
    assert len(kept) == len(rec["counts"]["model.rays_included"]) == period
    assert all(k > 0 for k in kept)
    assert sum(rec["counts"]["kernel.k1.bytes"]) > 0
    assert rec["model_flops"] > 0 and spans.window_s(rec) > 0
    assert _reader("train_mfu_counted_pct")(t) > 0
    # no device on the CPU: the device readers find nothing
    for name in ("step_idle_ms", "occupancy_device_ms",
                 "k1_counted_roofline_pct"):
        assert _reader(name)(t) is None


def test_tiny_render_stretch(tiny_records):
    _, t, _ = tiny_records
    rec = t["program"]
    names = [s[0] for s in rec["spans"]]
    chunks = names.count("model.forward")
    assert chunks >= 1 and names.count("eval.bake") == 1
    assert len(rec["counts"]["model.samples_shaded"]) == chunks
    assert all(s <= k for s, k in zip(rec["counts"]["model.samples_shaded"],
                                      rec["counts"]["model.samples_kept"]))
    assert _reader("render_mfu_counted_pct")(t) > 0
    for name in ("forward_idle_ms", "bake_mips_device_ms"):
        assert _reader(name)(t) is None
