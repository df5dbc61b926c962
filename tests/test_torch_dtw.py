"""Port parity, hard DTW: ``milnce_tpu_torch/ops/dtw.py`` against
``milnce_tpu/ops/dtw.py`` on the same numpy-seeded inputs in float64, at
square, rectangular, 1 x N and N x 1 shapes: the accumulated-cost table
and the backtracked path (exactly), ``dtw_loss`` and its gradients with
respect to both sequences (rtol 1e-10: the same float64 arithmetic, in
another order).  Plus a path checked by hand and ties resolved in the
reference's order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from milnce_tpu.ops import dtw as jax_dtw
from milnce_tpu_torch.ops import dtw_loss, dtw_path, dtw_table

torch.set_num_threads(1)         # six test workers share the cores

SHAPES = [(3, 5, 5), (2, 4, 7), (2, 7, 3), (2, 1, 6), (2, 6, 1), (1, 1, 1)]
_IDS = ["square", "wide", "tall", "1xN", "Nx1", "1x1"]


def _cost(b, n, m, seed):
    return np.random.default_rng(seed).random((b, n, m))


@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_table_and_path_match_jax(shape):
    cost = _cost(*shape, seed=sum(shape))
    with jax.enable_x64(True):
        want_tc = np.asarray(jax_dtw.dtw_table(jnp.asarray(cost)))
        want_path = np.asarray(jax_dtw.dtw_path(jnp.asarray(cost)))
    got_tc = dtw_table(torch.from_numpy(cost)).numpy()
    np.testing.assert_allclose(got_tc, want_tc, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(dtw_path(torch.from_numpy(cost)).numpy(),
                                  want_path)


@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_loss_and_gradients_match_jax(shape):
    b, n, m = shape
    rng = np.random.default_rng(100 + n * m)
    x, y = rng.standard_normal((b, n, 8)), rng.standard_normal((b, m, 8))
    with jax.enable_x64(True):
        def total(a, c):
            return jnp.sum(jax_dtw.dtw_loss(a, c))

        want = np.asarray(jax_dtw.dtw_loss(jnp.asarray(x), jnp.asarray(y)))
        want_gx, want_gy = (np.asarray(g) for g in jax.grad(
            total, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y)))
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    got = dtw_loss(tx, ty)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(tx.grad.numpy(), want_gx, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ty.grad.numpy(), want_gy, rtol=1e-10,
                               atol=1e-12)


def test_path_by_hand_and_ties():
    """A cost with one cheap diagonal gives that diagonal; an all-equal
    cost ties the diagonal with a neighbour at every step and takes the
    diagonal, as the reference's check order does, then stops at the
    first border it hits, marking (0, 0) apart; the table is the
    recurrence."""
    cost = torch.full((1, 4, 4), 5.0, dtype=torch.float64)
    cost[0, range(4), range(4)] = 0.0
    np.testing.assert_array_equal(dtw_path(cost)[0].numpy(), np.eye(4))
    flat = torch.ones((1, 3, 5), dtype=torch.float64)
    want = np.zeros((3, 5))
    want[[0, 0, 1, 2], [0, 2, 3, 4]] = 1.0
    np.testing.assert_array_equal(dtw_path(flat)[0].numpy(), want)
    tc = dtw_table(flat)[0].numpy()
    ref = np.full((4, 6), np.inf)
    ref[0, 0] = 0.0
    for i in range(1, 4):
        for j in range(1, 6):
            ref[i, j] = 1.0 + min(ref[i - 1, j - 1], ref[i - 1, j],
                                  ref[i, j - 1])
    np.testing.assert_array_equal(tc, ref[1:, 1:])
