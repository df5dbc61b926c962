"""The port's CUDA kernels on the card: each MIL-NCE stream kernel and
each soft-DTW kernel against its plain PyTorch version, the chunked loss
on the kernels against the dense loss, and soft-DTW on the kernels
against autograd through the plain recurrence.  Marked ``cuda``; every
test skips without a CUDA device (the check runs inside a fixture, never
at import).  On the card:
``python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerance: |kernel - plain| <= 1e-5 + 1e-4 * max|plain| (f32; the stream
sums in another order over up to Bg*K columns, the soft-DTW kernels
repeat their plain versions' arithmetic).
"""

import numpy as np
import pytest
import torch

from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.losses.milnce_chunked import milnce_loss_chunked
from milnce_tpu_torch.ops import milnce_stream as ms
from milnce_tpu_torch.ops import softdtw as tsd
from milnce_tpu_torch.ops import softdtw_cuda as sd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    lim = 1e-5 + 1e-4 * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim


@pytest.mark.parametrize("b,bg,k,d,chunk", [
    (3, 3, 2, 16, 2), (5, 37, 3, 40, 8), (33, 130, 1, 64, 100),
    (16, 16, 5, 512, 8)], ids=["tiny", "odd-d", "uneven", "train"])
def test_kernels_match_plain(cuda, b, bg, k, d, chunk):
    rng = np.random.default_rng(b + bg)
    arrays = [torch.tensor(rng.standard_normal((n, d), np.float32),
                           device=cuda) for n in (b, b * k, bg, bg * k)]
    g_row = torch.tensor(rng.standard_normal(b, np.float32), device=cuda)
    g_col = torch.tensor(rng.standard_normal(b * k, np.float32), device=cuda)

    def run(stream):
        leaves = [a.clone().requires_grad_(True) for a in arrays]
        row, col = stream(*leaves, chunk)
        grads = torch.autograd.grad((row, col), leaves, (g_row, g_col))
        return [row.detach(), col.detach(), *grads]

    before = dict(ms.LAUNCHES)
    got = run(ms.milnce_stream)
    assert all(ms.LAUNCHES[n] == before[n] + 2 for n in before)
    for a, w in zip(got, run(ms.milnce_stream_plain)):
        _close(a, w)


def test_chunked_loss_on_kernels_matches_dense(cuda):
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.standard_normal((12, 32), np.float32), device=cuda)
    t = torch.tensor(rng.standard_normal((36, 32), np.float32), device=cuda)

    def value_and_grads(fn):
        a, b = v.clone().requires_grad_(True), t.clone().requires_grad_(True)
        loss = fn(a, b)
        loss.backward()
        return loss.detach(), a.grad, b.grad

    got = value_and_grads(lambda a, b: milnce_loss_chunked(a, b, chunk=5,
                                                           backend="cuda"))
    for x, y in zip(got, value_and_grads(milnce_loss)):
        _close(x, y)


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ms.lse_fwd(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        ms.lse_fwd(torch.zeros(8, 4, device=cuda).T, a)
    with pytest.raises(ValueError, match="shared"):
        ms.lse_bwd_cols(torch.zeros(2, 4096, device=cuda),
                        torch.zeros(2, 4096, device=cuda),
                        torch.zeros(2, device=cuda), torch.zeros(2, device=cuda))


@pytest.mark.parametrize("b,n,m,band", [(7, 5, 9, 0), (3, 300, 280, 40),
                                        (2, 1100, 1030, 0)],
                         ids=["uneven", "banded", "past-1024"])
def test_softdtw_kernels_match_plain(cuda, b, n, m, band):
    rng = np.random.default_rng(n)
    D = torch.tensor(rng.standard_normal((b, n, m), np.float32) * 0.1,
                     device=cuda)
    before = dict(sd.LAUNCHES)
    value, r = sd.softdtw_fwd(D, 0.1, band)
    want_value, want_r = sd.softdtw_fwd_plain(D, 0.1, band)
    e = sd.softdtw_bwd(want_r, 0.1, band)
    assert all(sd.LAUNCHES[k] == before[k] + 1 for k in before)
    _close(value, want_value)
    real = want_r < tsd.BIG / 2
    assert torch.equal(real, r < tsd.BIG / 2)
    _close(r[real], want_r[real])
    _close(e, sd.softdtw_bwd_plain(want_r, 0.1, band))


def test_softdtw_on_kernels_matches_scan_autograd(cuda):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((6, 5, 16), np.float32), device=cuda)
    y = torch.tensor(rng.standard_normal((6, 7, 16), np.float32), device=cuda)

    def value_and_grads(backend):
        a, b = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        out = tsd.SoftDTW(gamma=0.1, dist_func="negative_dot",
                          backend=backend)(a, b)
        out.sum().backward()
        return out.detach(), a.grad, b.grad

    for got, want in zip(value_and_grads("cuda"), value_and_grads("scan")):
        _close(got, want)


def test_softdtw_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    D = torch.zeros(2, 4, 3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sd.softdtw_fwd(D.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        sd.softdtw_fwd(torch.zeros(2, 3, 4, device=cuda).transpose(1, 2), 0.1)
    _, r = sd.softdtw_fwd(D, 0.1)
    with pytest.raises(TypeError, match="float32"):
        sd.softdtw_bwd(r.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        sd.softdtw_bwd(r.transpose(0, 1), 0.1)
