"""The yardstick's arithmetic against counts made by hand."""

import math

import pytest
import torch

from benchmarks.yardstick import compare, flops, launches, roofline, trace


def test_gather_and_scatter_bytes():
    # 10 indices of 4 bytes, 10 rows of 8 bytes written, 3 distinct
    # rows of 8 bytes read
    assert roofline.gather_bytes(10, 8, 3) == 40 + 80 + 24
    # 10 indices and 10 rows of 2 float32 read, a 5 x 2 table written
    assert roofline.scatter_bytes(10, 2, 5) == 10 * (4 + 8) + 40
    assert roofline.scatter_bytes(4, 1, 3, value_bytes=8) == 4 * 12 + 24


def test_training_stream_bound_matches_the_kernel_table():
    # K1 on the training stream: 134,217,728 rows into 8,388,608 x 2,
    # 0.501 ms at 3.35 TB/s (the port's kernel table)
    nbytes = roofline.scatter_bytes(134_217_728, 2, 8_388_608)
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(0.501, abs=5e-4)
    # G1 on it: 4,956,406 distinct rows, 0.4926 ms
    nbytes = roofline.gather_bytes(134_217_728, 8, 4_956_406)
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(0.4926,
                                                           abs=5e-4)


def test_share():
    assert roofline.share_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share_pct(100, 0.0) is None
    assert roofline.share_pct(0, 1.0) is None


def test_mlp_flops():
    # 3 -> 4 -> 2: 2 * (12 + 8)
    assert flops.mlp_flops([3, 4, 2]) == 40


def test_neus_step_flops():
    dims = {"geometry": [3, 4, 2], "mlp": [5, 2]}
    # per sample 6 g + 3 t = 6 * 40 + 3 * 20
    assert flops.neus_train_step(dims, 10) == 10 * 300
    cfg = {"model": {"geometry": {}}}
    assert flops.train_step(dims, cfg, 10, 7) == 3000


def test_split_flops():
    dims = {"geometry": [3, 4, 2], "albedo": [2, 2], "roughness": [2, 1],
            "metallic": [2, 1], "env": [2, 3], "secondary": [4, 1]}
    g, heads, s = 40, 8 + 4 + 4 + 12, 8
    per_sample = 3 * 7 * g + 6 * g / 4 + 3 * heads
    assert flops.split_train_step(dims, 10, 2, 6, 4) == pytest.approx(
        10 * per_sample + 2 * 3 * (g + s))
    cfg = {"model": {"geometry": {"curvature_probe_frac": 0.25}}}
    assert flops.train_step(dims, cfg, 10, 2) == pytest.approx(
        10 * per_sample + 2 * 3 * (g + s))
    assert flops.split_render_chunk(dims, 10, 5, 2) == pytest.approx(
        10 * 2 * g + 5 * heads + 2 * (g + s))


def _ev(name, dev, s, e, c=0):
    return (name, dev, float(s), float(e), c)


def test_reduce_busy_gaps_and_attribution():
    events = [
        _ev(trace.STRETCH, False, 0, 100),
        _ev("benchmark.k1", False, 10, 20),
        _ev("cudaLaunchKernel", False, 12, 13, 7),
        _ev("aten::mm", False, 40, 70),
        _ev("cudaLaunchKernel", False, 45, 46, 8),
        _ev("k1_kernel", True, 30, 50, 7),
        _ev("mm_kernel", True, 45, 60, 8),   # overlaps k1_kernel
        _ev("late", True, 95, 120, 9),       # clipped at the window
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # union of [30, 60] and [95, 100]
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["device_ops"][0] == ["k1_kernel", pytest.approx(20e-6)]
    gaps = dict(r["idle_gaps"])
    # [0, 30]: middle 15 inside benchmark.k1; [60, 95]: middle 77.5
    # inside no host event
    assert gaps["benchmark.k1"] == pytest.approx(30e-6)
    assert gaps["(no host event)"] == pytest.approx(35e-6)
    assert trace.attributed_seconds(events, "benchmark.k1") == \
        pytest.approx(20e-6)
    assert trace.attributed_seconds(events, "benchmark.g1") == 0.0
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_recorder_counts_distinct_rows():
    from rise_sdf_tpu_torch.ops import gather, scatter

    table = torch.randn(50, 2)
    idx = torch.tensor([1, 1, 2, 49, 2, 0], dtype=torch.int32)
    rec = launches.LaunchRecorder()
    with rec:
        out = gather.gather_rows(table, idx)
        scatter.scatter_add(idx, torch.ones(6, 2), 50)
    assert torch.equal(out, table[idx.long()])
    assert gather.gather_rows.__name__ == "gather_rows"
    assert not hasattr(gather.gather_rows, "__wrapped__")
    assert rec.bytes_of("g1") == roofline.gather_bytes(6, 8, 4)
    assert rec.bytes_of("k1") == roofline.scatter_bytes(6, 2, 50)
    assert rec.bytes_of("k2") == 0


def test_train_numbers():
    ref = {"loss": [1.0, 2.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change": {"a": 0.1, "b": 0.2, "c": 5.0}}
    prog = {"loss": [1.001, 2.0], "grad": {"a": 1.1, "b": 2.0, "c": 0.0},
            "change": {"a": 0.1, "b": 0.1, "c": 0.0}}
    n = compare.train_numbers(prog, ref)
    assert n["loss_gap"] == pytest.approx(1e-3)
    # median of the reference gradients is 1.0
    assert n["grad_gap"] == pytest.approx(0.1)
    # leaf c moves by round-off alone and is left out; b by 0.1 of 0.2
    assert n["change_gap"] == pytest.approx(0.5)
    assert compare.judge(n, {"loss_gap": 2e-3, "grad_gap": 0.2,
                             "change_gap": 0.6})
    assert not compare.judge(n, {"loss_gap": 2e-3, "grad_gap": 0.2,
                                 "change_gap": 0.4})
    assert compare.judge(n, {"loss_gap": 1.0})
    assert not compare.judge(n, {"loss_gap": 1.0, "rgb_gap": 1.0})
    assert n["loss_gap_first"] == pytest.approx(1e-3)
    assert n["grad_gap_median"] == pytest.approx(1e-9)
    assert n["change_gap_median"] == pytest.approx(0.25)
    prog["grad"].pop("a")
    assert math.isinf(compare.train_numbers(prog, ref)["grad_gap"])


def test_render_numbers():
    import numpy as np

    ref = {"rgb": np.zeros((3, 3), np.float32),
           "included": np.array([True, True, False])}
    prog = {"rgb": np.array([[0, 0, 0.5], [0, 0.25, 0], [9, 9, 9]],
                            np.float32),
            "included": np.array([True, True, True])}
    n = compare.render_numbers(prog, ref)
    assert n == {"rgb_gap": 0.5, "included_mismatch": 1.0}
