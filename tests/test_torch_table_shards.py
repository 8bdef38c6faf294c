"""Hash-table row sharding (``system.table_shards``, JAX's ``model`` mesh
axis) of the port's encoding over gloo ranks on the CPU, held against
the JAX package's plain encode and its ``jax.grad``.

The small encoding of ``tests/test_table_sharding.py`` (4 levels, a
2^8 table; two dense levels, two hashed) at ``table_shards`` 2 (four
ranks as data=2 x model=2) and 4 (data=1 x model=4), each rank's shard
sliced from the JAX init: the plain encode, ``encode_with_grad`` and
``encode_axis_probes`` and the table gradient of each under a random
cotangent, gathered from the model group's shards, at that file's
tolerances (values rtol 1e-6 / atol 1e-7, gradients rtol 1e-5 / atol
1e-7; ``encode_with_grad`` rtol 1e-5 / atol 1e-6, as there); the
positions' gradient (every shard's part summed) and the table gradient
of a loss on it, through the double backward, at the Jacobian's.  Each
model group's ranks hold the same features bit for bit (the all-reduce
is their value), and under ``torch.use_deterministic_algorithms`` the
sharded gradient (K2's plain version, absent rows dropped) is held the
same way.  All rank work runs in one spawn of four ranks
(``tests/test_torch_table_shards_ranks.py::encode_rank``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_table_shards_ranks as ranks_mod
from rise_sdf_tpu.ops.hashgrid import HashGridEncoding as JaxHashGrid
from rise_sdf_tpu_torch.parallel import dryrun

WORLD = 4
VALUE = dict(rtol=1e-6, atol=1e-7)
GRAD = dict(rtol=1e-5, atol=1e-7)
JAC = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("table_shards"))
    enc = JaxHashGrid(3, dict(ranks_mod.SMALL, scatter_impl="xla"))
    table = np.asarray(enc.init(jax.random.PRNGKey(0))["table"])
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (96, 3)).astype(np.float32)
    eps = 1.0 / float(enc.resolutions[-1])
    probes = np.stack([np.clip(x + s * eps * np.eye(3, dtype=np.float32)[a],
                               0.0, 1.0)
                       for a, s in zip(ranks_mod.PROBE_AXES,
                                       (1, -1, 1, -1, 1, -1))])
    width = enc.n_output_dims
    cot = {"forward": rng.standard_normal((96, width)).astype(np.float32),
           "with_grad": [rng.standard_normal((96, width)).astype(np.float32)
                         for _ in range(4)],
           "probes": rng.standard_normal((7, 96, width)).astype(np.float32)}
    dryrun.spawn(ranks_mod.encode_rank, WORLD, "gloo",
                 args=(table, x, probes, cot, tmp))
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]

    t, xj, pj = jnp.asarray(table), jnp.asarray(x), jnp.asarray(probes)
    axes = ranks_mod.PROBE_AXES

    def fwd(tb):
        return enc.apply({"table": tb}, xj)

    def with_grad(tb):
        f, jac = enc.encode_with_grad({"table": tb}, xj)
        return (f,) + tuple(jac)

    def probed(tb):
        return enc.encode_axis_probes({"table": tb}, xj, pj, axes)

    def x_grad(tb, xx):
        return jax.grad(lambda y: jnp.sum(enc.apply({"table": tb}, y)
                                          * cot["forward"]))(xx)

    want = {"forward": np.asarray(fwd(t)),
            "x_grad": np.asarray(x_grad(t, xj)),
            "x_grad_grad": np.asarray(jax.grad(
                lambda tb: jnp.sum(x_grad(tb, xj) ** 2))(t)),
            "with_grad": [np.asarray(o) for o in with_grad(t)],
            "probes": np.asarray(probed(t)),
            "forward_grad": np.asarray(jax.grad(
                lambda tb: jnp.sum(fwd(tb) * cot["forward"]))(t)),
            "with_grad_grad": np.asarray(jax.grad(lambda tb: sum(
                jnp.sum(o * c) for o, c in zip(with_grad(tb),
                                               cot["with_grad"])))(t)),
            "probes_grad": np.asarray(jax.grad(
                lambda tb: jnp.sum(probed(tb) * cot["probes"]))(t))}
    return got, want


def _gathered(got, tp, key, data_index=0):
    """The model group's shards of ``key`` joined in shard order."""
    return np.concatenate([got[data_index * tp + m][tp][key].numpy()
                           for m in range(tp)], 1)


@pytest.mark.parametrize("tp", [2, 4])
def test_mesh_layout(run, tp):
    got, _ = run
    for r in range(WORLD):
        # rank r: data index r // tp, model index r % tp
        assert got[r][tp]["mesh"] == (WORLD // tp, tp, r // tp, r % tp)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key", ["forward", "probes"])
def test_sharded_encode_matches_jax(run, tp, key):
    got, want = run
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][tp][key].numpy(), want[key],
                                   **VALUE)
        # the all-reduce is the value on every rank of the group
        assert torch.equal(got[r][tp][key], got[r - r % tp][tp][key])


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_position_grad_matches_jax(run, tp):
    """The positions' gradient sums every shard's part (and equals on the
    group's ranks); a loss on it reaches the tables through the double
    backward."""
    got, want = run
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][tp]["x_grad"].numpy(),
                                   want["x_grad"], **JAC)
        assert torch.equal(got[r][tp]["x_grad"],
                           got[r - r % tp][tp]["x_grad"])
    for d in range(WORLD // tp):
        np.testing.assert_allclose(_gathered(got, tp, "x_grad_grad", d),
                                   want["x_grad_grad"], **JAC)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_encode_with_grad_matches_jax(run, tp):
    got, want = run
    for r in range(WORLD):
        for a, b in zip(got[r][tp]["with_grad"], want["with_grad"]):
            np.testing.assert_allclose(a.numpy(), b, **JAC)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key", ["forward_grad", "with_grad_grad",
                                 "probes_grad", "forward_grad_det"])
def test_sharded_table_grads_match_jax(run, tp, key):
    got, want = run
    ref = want[key.replace("_det", "")]
    for d in range(WORLD // tp):
        full = _gathered(got, tp, key, d)
        assert full.shape == ref.shape
        np.testing.assert_allclose(full, ref, **GRAD)


def test_each_shard_holds_its_own_rows(run):
    got, want = run
    ref = want["forward_grad"]
    for tp in (2, 4):
        rows = ref.shape[1] // tp
        for r in range(WORLD):
            m = r % tp
            g = got[r][tp]["forward_grad"].numpy()
            assert g.shape == (ref.shape[0], rows, ref.shape[2])
            np.testing.assert_allclose(g, ref[:, m * rows:(m + 1) * rows],
                                       **GRAD)
