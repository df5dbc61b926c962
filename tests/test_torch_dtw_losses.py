"""Port parity, DTW losses: ``milnce_tpu_torch/losses/dtw_losses.py``
against ``milnce_tpu/losses/dtw_losses.py`` (the JAX scan backend), the
``pair_chunk`` stream against the dense all-pairs form, and the train
step's dispatch of the loss knobs.

Sequences are made from a seed with numpy; both sides run in float64, so
values and gradients are held to ``rtol=1e-7, atol=1e-9`` (the same
recurrence and losses, summed in another order in places).  The clip
start times are f32 on both sides, as the step passes them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from milnce_tpu.losses import dtw_losses as jdl
from milnce_tpu_torch.config import LossConfig
from milnce_tpu_torch.losses import dtw_losses as tdl
from milnce_tpu_torch.train import step as tstep

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 1e-7, 1e-9


def _seqs(b=4, n=4, m=3, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, d)), rng.standard_normal((b, m, d)),
            (np.arange(b) * 7).astype(np.float32))


def _jax(fn, v, t):
    """value and (grad_v, grad_t) of a scalar JAX loss, in float64."""
    with jax.enable_x64(True):
        value, grads = jax.value_and_grad(fn, argnums=(0, 1))(
            jnp.asarray(v), jnp.asarray(t))
    return np.asarray(value), [np.asarray(g) for g in grads]


def _torch(fn, v, t):
    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    value = fn(tv, tt)
    value.backward()
    return value.detach().numpy(), [tv.grad.numpy(), tt.grad.numpy()]


def _same(got, want):
    np.testing.assert_allclose(got[0], want[0], RTOL, ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, RTOL, ATOL)


_LOSSES = {
    "cdtw": (lambda v, t, s: jdl.cdtw_batch_loss(v, t),
             lambda v, t, s: tdl.cdtw_batch_loss(v, t)),
    "cdtw_anchor": (lambda v, t, s: jdl.cdtw_loss(v, t, 2)[0],   # (1,)
                    lambda v, t, s: tdl.cdtw_loss(v, t, 2)[0]),
    "sdtw_cidm": (lambda v, t, s: jdl.sdtw_cidm_loss(v, t, s, sigma=10.0),
                  lambda v, t, s: tdl.sdtw_cidm_loss(v, t, s, sigma=10.0)),
    "sdtw_negative": (lambda v, t, s: jdl.sdtw_negative_loss(v, t),
                      lambda v, t, s: tdl.sdtw_negative_loss(v, t)),
    "sdtw_3": (lambda v, t, s: sum(jdl.sdtw_3_loss(v, t)),
               lambda v, t, s: sum(tdl.sdtw_3_loss(v, t))),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_matches_jax(name):
    """Each loss at its own default gamma and distance (cdtw 1e-5 and
    cosine, sdtw_* 0.1, sdtw_3 negative_dot), value and gradients."""
    v, t, start = _seqs(seed=len(name))
    jfn, tfn = _LOSSES[name]
    want = _jax(lambda a, b: jfn(a, b, jnp.asarray(start)), v, t)
    got = _torch(lambda a, b: tfn(a, b, torch.tensor(start)), v, t)
    _same(got, want)


def test_sdtw_3_terms_match_jax():
    v, t, _ = _seqs(b=3, n=4, m=4, seed=9)
    with jax.enable_x64(True):
        want = [float(x) for x in jdl.sdtw_3_loss(jnp.asarray(v),
                                                   jnp.asarray(t))]
    got = [float(x) for x in tdl.sdtw_3_loss(torch.tensor(v),
                                             torch.tensor(t))]
    np.testing.assert_allclose(got, want, RTOL, ATOL)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_pair_chunk_stream_matches_dense(chunk):
    """pair_chunk streams each term's negative logsumexp over anchor-row
    chunks (uneven tail at 2 and 3 for B=5) under checkpoint; value and
    gradients equal the dense all-pairs form and the JAX stream."""
    v, t, _ = _seqs(b=5, n=3, m=4, seed=11)

    def loss(pair_chunk, lib):
        return lambda a, b: sum(lib.sdtw_3_loss(a, b, gamma=0.1,
                                                pair_chunk=pair_chunk))

    dense = _torch(loss(0, tdl), v, t)
    _same(_torch(loss(chunk, tdl), v, t), dense)
    _same(_torch(loss(chunk, tdl), v, t), _jax(loss(chunk, jdl), v, t))


def test_exact_broadcast_matches_jax():
    v, t, start = _seqs(b=4, n=4, m=4, seed=13)
    start = np.array([0.0, 3.0, 20.0, 40.0], np.float32)

    def jfn(a, b):
        return jdl.sdtw_cidm_loss(a, b, jnp.asarray(start),
                                  exact_broadcast=True)

    def tfn(a, b):
        return tdl.sdtw_cidm_loss(a, b, torch.tensor(start),
                                  exact_broadcast=True)

    _same(_torch(tfn, v, t), _jax(jfn, v, t))
    v, t, start = _seqs(b=3, n=4, m=4)
    with pytest.raises(ValueError, match="B == n"):
        tdl.sdtw_cidm_loss(torch.tensor(v), torch.tensor(t),
                           torch.tensor(start), exact_broadcast=True)


def test_cidm_reads_start():
    v, t, _ = _seqs(seed=3)
    v, t = torch.tensor(v), torch.tensor(t)
    near = tdl.sdtw_cidm_loss(v, t, torch.zeros(4))
    far = tdl.sdtw_cidm_loss(v, t, torch.arange(4.0) * 20)
    assert float(near) != float(far)


def _dispatch(cfg, v, t, start):
    return float(tstep._sequence_loss(cfg, torch.tensor(v), torch.tensor(t),
                                      torch.tensor(start)))


def test_per_loss_gamma_defaults():
    """sdtw_gamma=None resolves to each loss's reference default: 1e-5 for
    cdtw, 0.1 for the sdtw_* family; an explicit value overrides."""
    v, t, start = _seqs(seed=5)
    for name, gamma in (("cdtw", 1e-5), ("sdtw_cidm", 0.1),
                        ("sdtw_negative", 0.1), ("sdtw_3", 0.1)):
        default = _dispatch(LossConfig(name=name), v, t, start)
        assert default == _dispatch(LossConfig(name=name, sdtw_gamma=gamma),
                                    v, t, start), name
        assert default != _dispatch(LossConfig(name=name, sdtw_gamma=0.5),
                                    v, t, start), name


def test_config_knobs_reach_the_dp(monkeypatch):
    """sdtw_dist, sdtw_bandwidth, cidm_sigma/cidm_lambda change the value;
    sdtw_pair_chunk and sdtw_backend reach sdtw_3_loss."""
    v, t, start = _seqs(b=4, n=4, m=4, seed=6)
    base = _dispatch(LossConfig(name="cdtw", sdtw_gamma=0.1), v, t, start)
    assert base != _dispatch(LossConfig(name="cdtw", sdtw_gamma=0.1,
                                        sdtw_bandwidth=1), v, t, start)
    assert base != _dispatch(LossConfig(name="cdtw", sdtw_gamma=0.1,
                                        sdtw_dist="negative_dot"),
                             v, t, start)
    cidm = _dispatch(LossConfig(name="sdtw_cidm"), v, t, start)
    assert cidm != _dispatch(LossConfig(name="sdtw_cidm", cidm_sigma=1.0),
                             v, t, start)
    assert cidm != _dispatch(LossConfig(name="sdtw_cidm", cidm_lambda=3.0),
                             v, t, start)
    seen = {}

    def fake_sdtw_3(v_seq, t_seq, **kw):
        seen.update(kw)
        return (v_seq.sum(), t_seq.sum(), v_seq.sum())

    monkeypatch.setattr(tstep, "sdtw_3_loss", fake_sdtw_3)
    _dispatch(LossConfig(name="sdtw_3", sdtw_pair_chunk=3,
                         sdtw_backend="scan"), v, t, start)
    assert seen["pair_chunk"] == 3 and seen["backend"] == "scan"


def test_chunked_stream_matches_dense_through_the_dispatch():
    v, t, start = _seqs(b=5, n=3, m=3, seed=8)
    dense = _dispatch(LossConfig(name="sdtw_3"), v, t, start)
    chunked = _dispatch(LossConfig(name="sdtw_3", sdtw_pair_chunk=2),
                        v, t, start)
    np.testing.assert_allclose(chunked, dense, RTOL, ATOL)
