"""Port parity, the bf16 mode of the MIL-NCE stream and the MFU peak of a
bf16 model.

The stream: the port's plain twin ``milnce_stream_plain`` against the JAX
Pallas stream ``milnce_stream_pallas`` (its kernel in interpret mode on
the CPU), every operand bf16 as a bf16 model hands them over, the
gathered ``v_all``/``t_all`` included.  Both upcast each block to f32 and
compute in f32, so the lse (f32) agree to f32 summation order, rtol 1e-5;
all four gradients come back bf16 in both, each an f32 sum rounded once,
so they agree within one bf16 ulp of each element (two where the local
operand is also the gathered one: its two bf16 gradients are added in
bf16 in both frameworks).  The plain twins on a bf16 B equal them on
B widened to f32, bit for bit: the contract the card's bf16 kernels
keep against their f32 mode (``tests/test_torch_cuda.py``).

The MFU gauge: a bf16 model's divides by the card's dense bf16
tensor-core rate, an f32 model's by 67 TFLOP/s (f32 without tensor
cores); ``MILNCE_PEAK_FLOPS`` overrides both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from milnce_tpu.ops.milnce_pallas import milnce_stream_pallas
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.ops.milnce_stream import (lse_bwd_cols_plain,
                                                lse_bwd_rows_plain, lse_plain,
                                                milnce_stream_plain)
from milnce_tpu_torch.parallel.dist import Ranks
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.curriculum import flat_stages
from milnce_tpu_torch.utils import roofline

from torch_bf16_close import bf16_ulp

torch.set_num_threads(1)         # six test workers share the cores

# (b, bg, k, d, chunk, shared): the local operands are the gathered ones
# (one device) or apart from them; an uneven last chunk in both
_CASES = {"shared": (4, 4, 3, 16, 3, True),
          "gathered": (3, 7, 2, 24, 3, False)}


def _operands(b, bg, k, d, shared, seed):
    rng = np.random.default_rng(seed)

    def draw(n):
        return (rng.standard_normal((n, d)) * d ** -0.25).astype(np.float32)

    v_all, t_all = draw(bg), draw(bg * k)
    v, t = (v_all, t_all) if shared else (draw(b), draw(b * k))
    g_row = rng.standard_normal(b).astype(np.float32)
    g_col = rng.standard_normal(b * k).astype(np.float32)
    return v, t, v_all, t_all, g_row, g_col


def _jax_stream(v, t, v_all, t_all, g_row, g_col, chunk, shared):
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (v, t, v_all, t_all)]
    if shared:
        out, vjp = jax.vjp(lambda a, b: milnce_stream_pallas(
            a, b, a, b, chunk), bf[0], bf[1])
    else:
        out, vjp = jax.vjp(lambda *x: milnce_stream_pallas(*x, chunk), *bf)
    grads = vjp((jnp.asarray(g_row), jnp.asarray(g_col)))
    return out, grads


def _port_stream(v, t, v_all, t_all, g_row, g_col, chunk, shared):
    leaves = [torch.tensor(x).to(torch.bfloat16).requires_grad_()
              for x in (v, t, v_all, t_all)]
    if shared:
        leaves[2], leaves[3] = leaves[0], leaves[1]
    out = milnce_stream_plain(*leaves, chunk)
    uniq = leaves[:2] if shared else leaves
    grads = torch.autograd.grad(out, uniq, (torch.tensor(g_row),
                                            torch.tensor(g_col)))
    return out, grads


@pytest.mark.parametrize("case", list(_CASES))
def test_bf16_stream_matches_the_pallas_kernel(case):
    b, bg, k, d, chunk, shared = _CASES[case]
    args = _operands(b, bg, k, d, shared, seed=len(case))
    (j_row, j_col), j_grads = _jax_stream(*args, chunk, shared)
    (t_row, t_col), t_grads = _port_stream(*args, chunk, shared)
    for got, want in ((t_row, j_row), (t_col, j_col)):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    ulps = 2 if shared else 1
    names = ["g_v", "g_t", "g_v_all", "g_t_all"]
    for name, got, want in zip(names, t_grads, j_grads):
        assert got.dtype == torch.bfloat16, name
        assert want.dtype == jnp.bfloat16, name      # as in JAX
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        assert (np.abs(got - want) <= ulps * bf16_ulp(want)).all(), name


@pytest.mark.parametrize("r,c,d,width,parts", [
    (4, 24, 16, 9, None), (7, 13, 40, 5, ((0, 32), (32, 8))),
    (3, 30, 24, 64, None)], ids=["ragged", "parts", "one-block"])
def test_bf16_b_is_the_f32_b_widened_in_the_plain_twins(r, c, d, width,
                                                        parts):
    """The contract the card's bf16 mode keeps, on the plain twins: a bf16
    gathered operand B gives what its f32 widening gives, bit for bit (the
    lse and dA; dB rounded to bf16 a block at a time, the f32 one's
    rounded once), since each block is widened before any arithmetic."""
    rng = np.random.default_rng(r + c + d)
    a = torch.tensor(rng.standard_normal((r, d)).astype(np.float32))
    b16 = torch.tensor(rng.standard_normal((c, d)).astype(np.float32)
                       * d ** -0.25).to(torch.bfloat16)
    b = b16.float()
    g = torch.tensor(rng.standard_normal(r).astype(np.float32))
    lse = lse_plain(a, b16, width, parts)
    assert lse.dtype == torch.float32
    assert torch.equal(lse, lse_plain(a, b, width, parts))
    da = lse_bwd_rows_plain(a, b16, lse, g, width, parts)
    assert da.dtype == torch.float32
    assert torch.equal(da, lse_bwd_rows_plain(a, b, lse, g, width, parts))
    db = lse_bwd_cols_plain(a, b16, lse, g, width, parts)
    assert db.dtype == torch.bfloat16
    assert torch.equal(db, lse_bwd_cols_plain(a, b, lse, g, width,
                                              parts).to(torch.bfloat16))


# ------------------------------------------------------------ the MFU peak
def test_peak_by_card_and_dtype(monkeypatch):
    monkeypatch.delenv("MILNCE_PEAK_FLOPS", raising=False)
    sxm, pcie, nvl = ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                      "NVIDIA H100 NVL")
    assert roofline.device_peak_flops(sxm) == 67e12
    assert roofline.device_peak_flops(sxm, "float32") == 67e12
    assert roofline.device_peak_flops(sxm, "bfloat16") == 989e12
    assert roofline.device_peak_flops(pcie, "bfloat16") == 756e12
    assert roofline.device_peak_flops(nvl, "bfloat16") == 835e12
    assert roofline.device_peak_flops("cpu", "bfloat16") is None
    monkeypatch.setenv("MILNCE_PEAK_FLOPS", "2.5e12")
    assert roofline.device_peak_flops(sxm, "bfloat16") == 2.5e12


@pytest.mark.parametrize("dtype,peak", [("float32", 67e12),
                                        ("bfloat16", 989e12)])
def test_mfu_gauge_divides_by_the_model_dtype_peak(monkeypatch, dtype, peak):
    """The loop's gauge on a run whose device reads as an H100: the
    roofline step FLOPs times the window's steps/s over the peak of the
    model's dtype."""
    monkeypatch.delenv("MILNCE_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "NVIDIA H100 80GB HBM3")
    cfg = tiny_preset()
    cfg.model.dtype = dtype
    obs = loop._RunObs(cfg, Ranks(), torch.device("cuda"), lambda _m: None)
    try:
        assert obs.peak == peak
        obs.set_stage(0, flat_stages(cfg.data, cfg.train.batch_size)[0])
        obs.display(step=2, epoch=0, window=2, elapsed=4.0, mean_loss=1.0,
                    lr=0.0, clips_per_sec=1.0, skipped=0, first_window=True)
        assert obs.last_mfu == roofline.mfu(obs.step_flops, 0.5, peak, 1)
        assert obs.g_mfu.value == obs.last_mfu
    finally:
        obs.close(2)
