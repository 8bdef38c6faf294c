"""Port parity: the row gather ``table[idx]`` (``ops/gather.py``, kernel
G1 on the card) against the JAX package's gathers on the CPU.

G1 replaces the Pallas TPU kernels S2 (``pallas_row_gather``) and S3
(``pallas_take_gather``, both ``scripts/pallas_gather_bench.py``) and S4
(``pallas_dma_gather``, ``scripts/r5_gather_width_bench.py``).  S2 and
S3 run here in Pallas interpret mode; S4 takes no interpret flag (its
per-row DMAs and semaphores are TPU-only), so its function, ``table[idx]``
at widths 2, 8 and 32, is held against XLA's ``table[idx]``.  A gather
moves values without arithmetic: every comparison is bit-equal.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu_torch.ops import gather, sdf_bake
from test_torch_streams import dense17_rows, ray_encode_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n, w, m, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, w)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("w", [2, 8, 32])
def test_gather_rows_plain_equals_jax_take(w):
    table, idx = _inputs(4096, w, 10000, w)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (10000, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.gather_rows_plain(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("kernel,m", [("pallas_row_gather", 8192),
                                      ("pallas_take_gather", 1 << 15)],
                         ids=["S2", "S3"])
def test_gather_rows_equals_pallas_interpret(kernel, m):
    """S2 and S3 read a ``[T/64, 128]`` packing of the ``[T, 2]`` table;
    their chunk sizes (8192, 2^15 rows) set ``m``."""
    fn = getattr(_script("pallas_gather_bench"), kernel)
    table, idx = _inputs(4096, 2, m, 1)
    want = np.asarray(fn(jnp.asarray(table.reshape(-1, 128)),
                         jnp.asarray(idx), True))
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stream", ["rays", "dense17"])
def test_gather_rows_on_encode_rows_equals_jax_take(stream):
    """The layouts G1 serves on the main path: ray-ordered [N, 16, 8]
    rows of the port's hash encode and the [N, 1, 8] rows of a dense
    17^3 level, cut so that M % 8 != 0, against XLA's ``table[idx]``."""
    rows, t = ray_encode_rows(8, 125) if stream == "rays" \
        else dense17_rows(1001)
    idx = rows.reshape(-1)[:-3].contiguous()
    table = np.random.default_rng(6).standard_normal((t, 2)).astype(
        np.float32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx.numpy())])
    got = gather.gather_rows(torch.from_numpy(table), idx)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,dtype", [(4, np.float32), (2, np.float64),
                                     (8, np.float32), (4, np.float64),
                                     (32, np.float32), (16, np.float64)],
                         ids=["q1_f32", "q1_f64", "q2_f32", "q2_f64",
                              "q8_f32", "q8_f64"])
def test_gather_rows16_with_absent_rows_equals_masked_take(w, dtype):
    """Rows of q = 1, 2, 8 16-byte vectors (G1's 16-byte path on the
    card), some of them absent (-1, another shard's): the port's gather
    equals JAX's ``where(idx < 0, 0, table[max(idx, 0)])`` (float32;
    numpy's for float64, which this JAX configuration keeps as float32)
    bit for bit."""
    table, idx = _inputs(3000, w, 7001, w)
    table = table.astype(dtype)
    idx[np.random.default_rng(w).uniform(size=idx.shape) < 0.25] = -1
    want = np.where((idx < 0)[:, None], 0, table[np.maximum(idx, 0)])
    if dtype == np.float32:
        jt, ji = jnp.asarray(table), jnp.asarray(idx)
        want_jax = np.asarray(jnp.where((ji < 0)[:, None], 0.0,
                                        jt[jnp.maximum(ji, 0)]))
        np.testing.assert_array_equal(want_jax, want)
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_gather_rows_float64_and_empty():
    table = torch.arange(12, dtype=torch.float64).view(6, 2)
    idx = torch.tensor([5, 0, 5], dtype=torch.int32)
    np.testing.assert_array_equal(gather.gather_rows(table, idx).numpy(),
                                  [[10, 11], [0, 1], [10, 11]])
    assert gather.gather_rows(table, idx[:0]).shape == (0, 2)


@pytest.mark.parametrize("bad", ["int64_idx", "int_table", "idx_2d",
                                 "strided_table", "12_byte_rows",
                                 "misaligned_idx"])
def test_gather_rows_rejects(bad):
    """Wrong types and layouts, and the row sizes and alignments G1 does
    not take, raise on the CPU as on the card."""
    table = torch.zeros((8, 4))
    idx = torch.zeros(3, dtype=torch.int32)
    if bad == "int64_idx":
        idx = idx.long()
    elif bad == "int_table":
        table = table.int()
    elif bad == "idx_2d":
        idx = idx.view(3, 1)
    elif bad == "strided_table":
        table = table[:, ::2]
    elif bad == "12_byte_rows":
        table = torch.zeros((8, 3))
    else:
        table, idx = torch.zeros((8, 2)), torch.zeros(8, dtype=torch.int32)[1:]
    with pytest.raises((TypeError, ValueError)):
        gather.gather_rows(table, idx)


def test_cpu_tensors_never_count_as_launches():
    before = gather.gather_rows.launches
    table, idx = _inputs(64, 8, 100, 3)
    gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert gather.gather_rows.launches == before


def test_baked_sdf_rows_gather_the_packed_table():
    """The baked-SDF sample reads one 8-wide row per sample through
    ``gather_rows``: the same rows as the JAX package's ``packed[flat]``."""
    from rise_sdf_tpu.ops import sdf_bake as jbake

    rng = np.random.default_rng(4)
    verts = rng.standard_normal((9, 9, 9)).astype(np.float32)
    bake = {"packed": sdf_bake.pack_corners(torch.from_numpy(verts)),
            "cells": 8}
    pos = rng.uniform(-1.6, 1.6, (500, 3)).astype(np.float32)
    lo, hi = torch.full((3,), -1.5), torch.full((3,), 1.5)
    i, _ = sdf_bake._cell_coords(torch.from_numpy(pos), lo, hi, 8)
    got = sdf_bake._rows(bake, i)
    ji, _ = jbake._cell_coords(jnp.asarray(pos), jnp.full(3, -1.5),
                               jnp.full(3, 1.5), 8)
    flat = (ji[..., 0] * 9 + ji[..., 1]) * 9 + ji[..., 2]
    want = np.asarray(jbake.pack_corners(jnp.asarray(verts)))[
        np.asarray(flat)]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [0, 1], ids=["recorded", "past_the_end"])
def test_recording_bake_reads_the_chunks_bake_rows(chunk):
    """``chip_smoke.py``'s bake-stream recorder on the tiny bench (one
    chunk of 256 rays, a 32-cell bake): chunk 0's visibility probe (256
    rays x 64 probes) and secondary alpha each read the packed table
    once, through G1's wrapper, and the recorded rows gather what the
    renderer read; a chunk past the image's last records nothing; the
    renderer and the bake module are restored after."""
    import chip_smoke
    from rise_sdf_tpu_torch import bench
    from rise_sdf_tpu_torch.models.split_mixed_occ import SplitMixedOccModel

    hooks = (SplitMixedOccModel.forward, sdf_bake.sample_packed,
             sdf_bake.sample_packed_grad, sdf_bake.gather_rows)
    read = []

    def reading(table, idx):
        read.append((table, idx.clone()))
        return gather.gather_rows(table, idx)

    sdf_bake.gather_rows = reading
    try:
        with chip_smoke.recording_bake(chunk) as seen:
            bench.run("tiny", "cpu")
    finally:
        sdf_bake.gather_rows = gather.gather_rows
    assert (SplitMixedOccModel.forward, sdf_bake.sample_packed,
            sdf_bake.sample_packed_grad, sdf_bake.gather_rows) == hooks
    if chunk:
        assert seen["probe"] == seen["alpha"] == [] and "table" not in seen
        return
    assert len(seen["probe"]) == len(seen["alpha"]) == 1
    probe, alpha = seen["probe"][0], seen["alpha"][0]
    assert probe.dtype == alpha.dtype == torch.int32
    assert probe.shape == (256 * 64,) and 0 < alpha.numel() < probe.numel()
    assert tuple(seen["table"].shape) == (33 ** 3, 8)
    assert int(torch.cat([probe, alpha]).min()) >= 0
    assert int(torch.cat([probe, alpha]).max()) < 33 ** 3
    # the warm-up chunk's two reads, then the recorded chunk's
    assert [tuple(i.shape) for _, i in read[2:4]] == [
        tuple(probe.shape), tuple(alpha.shape)]
    for (table, idx), rec in zip(read[2:4], (probe, alpha)):
        assert table is seen["table"] and torch.equal(idx, rec)
