"""The port's CUDA kernels on the card: each MIL-NCE stream kernel against
its plain PyTorch version, and a training step on the kernels against the
dense loss.  Marked ``cuda``; every test skips without a CUDA device
(the check runs inside a fixture, never at import).  On the card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerance: |kernel - plain| <= 1e-5 + 1e-4 * max|plain| (f32, sums taken
in another order over up to Bg*K columns).
"""

import numpy as np
import pytest
import torch

from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.losses.milnce_chunked import milnce_loss_chunked
from milnce_tpu_torch.ops import milnce_stream as ms

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
