"""Port parity, sequence-parallel soft-DTW (``milnce_tpu_torch/ops/
softdtw_sp.py``) over ``torch.distributed`` (gloo, CPU) against JAX
``milnce_tpu/ops/softdtw_sp.py::softdtw_seq_parallel`` on a mesh of the
same number of virtual devices, and against the port's plain recurrence
(``ops/softdtw.py::softdtw_scan``, float64) on one process.

At W = 2, 3 and 4 ranks (one spawn each): square and rectangular costs,
rows that W does not divide, fewer rows than ranks, a Sakoe-Chiba band;
the values and the gradient of ``sum(g * value)`` (a random cotangent),
rtol 1e-5, atol 1e-5, on every rank.  The rows-local entry
(``softdtw_seq_parallel_rows``, each rank passing only its own rows) in
the same spawns: the values, and each rank's gradient rows against the
matching row block of JAX's gradient; no tensor it saves for the
backward has N rows.  A band narrower than |N - M| is refused before any
collective.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_dist_worker as worker
from milnce_tpu.ops.softdtw_sp import softdtw_seq_parallel as jax_sp
from milnce_tpu_torch.ops import (softdtw_seq_parallel,
                                  softdtw_seq_parallel_rows)
from milnce_tpu_torch.ops.softdtw import softdtw_scan

torch.set_num_threads(1)         # six test workers share the cores

RTOL = ATOL = 1e-5
CASES = {                         # label: (B, N, M, gamma, bandwidth)
    "square": (3, 16, 16, 0.5, 0),
    "tall": (2, 24, 10, 0.5, 0),
    "wide": (2, 9, 17, 0.3, 0),
    "indivisible": (2, 13, 11, 0.3, 0),
    "fewer-rows": (2, 3, 7, 0.5, 0),
    "band": (2, 16, 16, 0.5, 3),
}
WORLDS = (2, 3, 4)


def _inputs():
    out = {}
    for i, (label, (b, n, m, gamma, band)) in enumerate(CASES.items()):
        rng = np.random.RandomState(10 + i)
        out[label] = (rng.rand(b, n, m).astype(np.float32), gamma, band,
                      (rng.rand(b) + 0.5).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    return inputs, {w: worker.spawn(worker.softdtw_sp_cases, w,
                                    tmp_path_factory.mktemp(f"sp-w{w}"),
                                    inputs)
                    for w in WORLDS}


def _jax(D, gamma, band, g, world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    value, vjp = jax.vjp(lambda d: jax_sp(d, gamma, mesh, bandwidth=band),
                         jnp.asarray(D))
    return np.asarray(value), np.asarray(vjp(jnp.asarray(g))[0])


def _scan(D, gamma, band, g):
    x = torch.from_numpy(D).double().requires_grad_()
    value = softdtw_scan(x, gamma, band)
    (value * torch.from_numpy(g).double()).sum().backward()
    return value.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", list(CASES))
def test_matches_jax_and_the_plain_recurrence(runs, label, world):
    inputs, ranks = runs
    D, gamma, band, g = inputs[label]
    jax_value, jax_grad = _jax(D, gamma, band, g, world)
    scan_value, scan_grad = _scan(D, gamma, band, g)
    for r, result in enumerate(ranks[world]):
        value, grad = result[label]
        assert value.dtype == np.float32 and grad.shape == D.shape
        for want, got, what in [(jax_value, value, "value vs JAX"),
                                (jax_grad, grad, "grad vs JAX"),
                                (scan_value, value, "value vs scan"),
                                (scan_grad, grad, "grad vs scan")]:
            np.testing.assert_allclose(got, want, RTOL, ATOL,
                                       err_msg=f"rank {r}: {what}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", list(CASES))
def test_rows_local_entry_matches_jax_row_blocks(runs, label, world):
    inputs, ranks = runs
    D, gamma, band, g = inputs[label]
    b, n, m = D.shape
    k = -(-n // world)
    jax_value, jax_grad = _jax(D, gamma, band, g, world)
    for r, result in enumerate(ranks[world]):
        value, grad_rows, saved = result[("rows", label)]
        assert value.dtype == np.float32 and grad_rows.shape == (b, k, m)
        np.testing.assert_allclose(value, jax_value, RTOL, ATOL,
                                   err_msg=f"rank {r}: value vs JAX")
        block = jax_grad[:, r * k:(r + 1) * k]
        np.testing.assert_allclose(grad_rows[:, :block.shape[1]], block,
                                   RTOL, ATOL,
                                   err_msg=f"rank {r}: grad rows vs JAX")
        assert not grad_rows[:, block.shape[1]:].any(), "padding's grad"
        # saved for the backward: the rank's table on the diagonals its
        # rows reach (L, B, k), the (N + M + 1, B) halos and the (k,)
        # row numbers; nothing of N rows
        assert saved, "nothing saved"
        for shape in saved:
            assert (shape == (k,) or shape == (n + m + 1, b)
                    or (len(shape) == 3 and shape[1:] == (b, k)
                        and shape[0] <= k + m + 1)), (r, shape, saved)


def test_narrow_band_is_refused():
    D = torch.ones((2, 10, 4))
    with pytest.raises(ValueError, match="bandwidth"):
        softdtw_seq_parallel(D, 1.0, None, bandwidth=3)
    with pytest.raises(ValueError, match="bandwidth"):
        softdtw_seq_parallel_rows(D[:, :5], 10, 1.0, None, bandwidth=3)
    with pytest.raises(ValueError, match="bandwidth"):
        jax_sp(jnp.ones((2, 10, 4)), 1.0,
               Mesh(np.array(jax.devices()[:2]), ("data",)), bandwidth=3)
