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

import dataclasses

import numpy as np
import pytest
import torch

from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.losses.milnce_chunked import milnce_loss_chunked
from milnce_tpu_torch.ops import milnce_stream as ms
from milnce_tpu_torch.ops import softdtw as tsd
from milnce_tpu_torch.ops import softdtw_cuda as sd

torch.set_num_threads(1)         # six test workers share the cores

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
    (16, 16, 5, 512, 8), (33, 8191, 1, 13, 1000), (33, 8191, 1, 512, 1000),
    (128, 1024, 5, 512, 64), (5, 300, 2, 700, 64), (2048, 40, 1, 512, 40),
    (200, 3000, 3, 512, 300), (4, 8, 3, 769, 3), (33, 300, 3, 1000, 100),
    (8, 64, 2, 2048, 16)],
    ids=["tiny", "odd-d", "uneven", "train", "d13-r33", "r33-bg8191",
         "r640", "d700", "split", "fwd-split", "deep-d769", "deep-d1000",
         "deep-d2048"])
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
    mode = "" if d <= ms.STREAM_DMAX else "_deep"
    assert all(ms.LAUNCHES[n + mode] == before[n + mode] + 2
               for n in ms.KERNELS)
    assert sum(ms.LAUNCHES.values()) == sum(before.values()) + 6
    for a, w in zip(got, run(ms.milnce_stream_plain)):
        _close(a, w)


@pytest.mark.parametrize("r,c,where", [
    (33, 3000, "b-tile"), (33, 3000, "b-tail"), (33, 3000, "a-row"),
    (640, 8192, "b-tile"), (640, 8192, "a-row")])
def test_lse_fwd_propagates_nan(cuda, r, c, where):
    """A NaN logit makes its row's lse NaN, as in ``lse_plain``: a block of
    B's rows as wide as a streamed tile, B's last rows (the ragged tile),
    or one row of A."""
    rng = np.random.default_rng(r + c)
    a = torch.tensor(rng.standard_normal((r, 512), np.float32), device=cuda)
    b = torch.tensor(rng.standard_normal((c, 512), np.float32), device=cuda)
    if where == "b-tile":
        b[128:384] = float("nan")
    elif where == "b-tail":
        b[-5:] = float("nan")
    else:
        a[7] = float("nan")
    got, want = ms.lse_fwd(a, b), ms.lse_plain(a, b, 4096)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(want.isnan().any())
    ok = ~want.isnan()
    if bool(ok.any()):
        _close(got[ok], want[ok])


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


@pytest.mark.parametrize("d", [768, 1024])
def test_auto_stream_launches_the_kernels_or_refuses_the_depth(cuda, d):
    """``milnce_stream`` (backend ``auto``) on CUDA tensors launches the
    kernels at every depth, held up to STREAM_DMAX and in the deep mode
    past it: it never takes the plain stream on the card."""
    rng = np.random.default_rng(d)
    arrays = [torch.tensor(rng.standard_normal((n, d), np.float32),
                           device=cuda) for n in (4, 8, 12, 24)]
    ms.reset_launches()
    row, col = ms.milnce_stream(*arrays, 5)
    name = "lse_fwd" if d <= ms.STREAM_DMAX else "lse_fwd_deep"
    assert ms.LAUNCHES[name] == 2 and sum(ms.LAUNCHES.values()) == 2
    _close(row, ms.milnce_stream_plain(*arrays, 5)[0])
    _close(col, ms.milnce_stream_plain(*arrays, 5)[1])


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ms.lse_fwd(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        ms.lse_fwd(torch.zeros(8, 4, device=cuda).T, a)
    # D = 4096 is no longer refused: each wrapper launches its deep mode
    rng = np.random.default_rng(4096)
    wide = [torch.tensor(rng.standard_normal((n, 4096), np.float32) / 8,
                         device=cuda) for n in (2, 3)]
    lse = ms.lse_plain(*wide, 4096)
    g = torch.ones(2, device=cuda)
    _close(ms.lse_fwd(*wide), lse)
    _close(ms.lse_bwd_rows(*wide, lse, g),
           ms.lse_bwd_rows_plain(*wide, lse, g, 4096))
    _close(ms.lse_bwd_cols(*wide, lse, g),
           ms.lse_bwd_cols_plain(*wide, lse, g, 4096))


@pytest.mark.parametrize("b,n,m,band", [
    (7, 5, 9, 0), (3, 300, 280, 40), (2, 1100, 1030, 0), (256, 4, 4, 0),
    (256, 4, 5, 0), (256, 5, 5, 0), (1, 2600, 20, 0)],
    ids=["uneven", "banded", "past-1024", "train-vv", "train-vt", "train-tt",
         "past-ring"])
def test_softdtw_kernels_match_plain(cuda, b, n, m, band):
    """Each kernel against its plain twin; the backward's grad_D under a
    random cotangent and under ones(1).expand(B).  The training shapes put
    several pairs in a block (and in a warp, in the forward); N = 2600
    puts the backward's ring in global scratch, and past 1024 rows the
    forward goes in stripes.  The forward's value and R are its twin's bit
    for bit."""
    rng = np.random.default_rng(n)
    D = torch.tensor(rng.standard_normal((b, n, m), np.float32) * 0.1,
                     device=cuda)
    plan = sd.bwd_plan(b, n, m)
    assert (plan.pairs_per_block > 1) == (n + 2 <= 32)
    assert (plan.ring == "global") == (n == 2600)
    assert sd.fwd_plan(b, n, m).stripes == -(-n // sd.FWD_MAX_THREADS)
    g = torch.tensor(rng.standard_normal(b, np.float32), device=cuda)
    want_value, want_r = sd.softdtw_fwd_plain(D, 0.1, band)
    before = dict(sd.LAUNCHES)
    value, r = sd.softdtw_fwd(D, 0.1, band)
    grad = sd.softdtw_bwd(want_r, g, 0.1, band)
    assert all(sd.LAUNCHES[k] == before[k] + 1 for k in before)
    assert torch.equal(value, want_value) and torch.equal(r, want_r)
    _close(value, want_value)
    real = want_r < tsd.BIG / 2
    assert torch.equal(real, r < tsd.BIG / 2)
    _close(r[real], want_r[real])
    assert grad.shape == (b, n, m) and grad.dtype == torch.float32
    _close(grad, sd.softdtw_bwd_plain(want_r, g, 0.1, band))
    ones = torch.ones(1, device=cuda).expand(b)
    _close(sd.softdtw_bwd(want_r, ones, 0.1, band),
           sd.softdtw_bwd_plain(want_r, ones, 0.1, band))


@pytest.mark.parametrize("b,n,m", [(256, 4, 5), (3, 40, 37)],
                         ids=["pairs-a-warp", "block-a-pair"])
def test_softdtw_bwd_nan_and_inf_cells_match_plain(cuda, b, n, m):
    """A NaN block and an inf block in D: their cells and what they cut
    off are dead in R, and a NaN cotangent entry makes its pair NaN.  The
    zero and NaN cells of grad_D are the same sets as the twin's, and the
    rest agrees."""
    rng = np.random.default_rng(b + n)
    D = torch.tensor(rng.standard_normal((b, n, m), np.float32) * 0.1,
                     device=cuda)
    D[0, 1:3, 1:3] = float("nan")
    D[1, 0:2, 2:4] = float("inf")
    g = torch.tensor(rng.standard_normal(b, np.float32), device=cuda)
    g[2] = float("nan")
    _, r = sd.softdtw_fwd_plain(D, 0.1)
    got = sd.softdtw_bwd(r, g, 0.1)
    want = sd.softdtw_bwd_plain(r, g, 0.1)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got == 0, want == 0)
    assert bool(want.isnan().any()) and bool((want == 0).any())
    ok = ~want.isnan()
    _close(got[ok], want[ok])


@pytest.mark.parametrize("b,n,m", [(256, 4, 5), (3, 40, 37)],
                         ids=["pairs-a-warp", "block-a-pair"])
def test_softdtw_fwd_nan_and_inf_costs_match_plain(cuda, b, n, m):
    """A NaN block and a +inf block in D: the NaN cells and the BIG cells
    of R are the same sets as the twin's, and the rest agrees.  The kernel
    takes the max by fmaxf, which drops a NaN where torch.maximum keeps
    it; the NaN still reaches the cell through its exp, so a rewrite that
    changed what the max sees would show here."""
    rng = np.random.default_rng(b + n)
    D = torch.tensor(rng.standard_normal((b, n, m), np.float32) * 0.1,
                     device=cuda)
    D[0, 1:3, 1:3] = float("nan")
    D[1, 0:2, 2:4] = float("inf")
    value, r = sd.softdtw_fwd(D, 0.1)
    want_value, want_r = sd.softdtw_fwd_plain(D, 0.1)
    assert torch.equal(r.isnan(), want_r.isnan())
    assert torch.equal(r >= tsd.BIG / 2, want_r >= tsd.BIG / 2)
    assert torch.equal(value.isnan(), want_value.isnan())
    assert bool(want_r.isnan().any()) and bool(want_r.isinf().any())
    assert torch.equal(r.isinf(), want_r.isinf())
    ok = ~(want_r.isnan() | want_r.isinf() | (want_r >= tsd.BIG / 2))
    _close(r[ok], want_r[ok])
    ok = ~want_value.isnan()
    _close(value[ok], want_value[ok])


def test_softdtw_fwd_refuses_a_plan_it_cannot_run(cuda, monkeypatch):
    """The C entry checks the launch plan and returns an error for one it
    cannot run; the wrapper raises, launching nothing."""
    D = torch.zeros(4, 40, 7, device=cuda)
    plan = sd.fwd_plan(4, 40, 7)
    monkeypatch.setattr(sd, "fwd_plan", lambda *a: dataclasses.replace(
        plan, smem_bytes=plan.smem_bytes + 8))
    before = sd.LAUNCHES["softdtw_fwd"]
    with pytest.raises(RuntimeError, match="softdtw_fwd"):
        sd.softdtw_fwd(D, 0.1)
    assert sd.LAUNCHES["softdtw_fwd"] == before


@pytest.mark.parametrize("b,n,m,packed", [
    (4, 32, 1 << 24, True), (1, 512, 4294967, False), (1, 2, 1 << 26, False)],
    ids=["pairs-a-warp", "block-a-pair", "long-rows"])
def test_softdtw_fwd_takes_costs_past_2_31(cuda, b, n, m, packed):
    """Costs past 2^31 floats: a block of four 32-row pairs whose costs
    span 2^31 floats (9 GB of D, 9 GB of R); one pair whose rows from 501
    on start past 2^31 (the same); and rows of 2^26 costs, which go as a
    long pair.  R(i, j) for j <= 40 depends on D[:, :, :40] alone, so
    there it is the twin's table of those costs, bit for bit."""
    plan = sd.fwd_plan(b, n, m)
    assert (plan.pairs_per_block > 1) == packed
    assert max(plan.pairs_per_block * n, n - 1, 32) * m >= 2**31
    torch.manual_seed(n)
    D = torch.rand((b, n, m), device=cuda)
    value, r = sd.softdtw_fwd(D, 0.1)
    j0 = 40
    _, want_r = sd.softdtw_fwd_plain(D[:, :, :j0].contiguous(), 0.1)
    i = torch.arange(n + 1, device=cuda)[:, None]
    j = torch.arange(j0 + 1, device=cuda)[None, :]
    assert torch.equal(r[:, i + j, i], want_r[:, i + j, i])
    assert torch.equal(value, r[:, n + m, n])
    assert bool(value.isfinite().all())


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
    g = torch.ones(2, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sd.softdtw_bwd(r.double(), g, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        sd.softdtw_bwd(r.transpose(0, 1), g, 0.1)
    with pytest.raises(ValueError, match="shape"):
        sd.softdtw_bwd(r, torch.ones(3, device=cuda), 0.1)
    with pytest.raises(ValueError, match="shape"):
        sd.softdtw_bwd(r, torch.ones(2, 1, device=cuda), 0.1)
    with pytest.raises(TypeError, match="float32"):
        sd.softdtw_bwd(r, g.double(), 0.1)
    with pytest.raises(ValueError, match="device"):
        sd.softdtw_bwd(r, torch.ones(2), 0.1)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_device_prefetch_on_the_card_matches_the_host(cuda, depth):
    """Every batch copied through the pinned ring on the side stream is
    the host's, byte for byte, while the consumer's stream works on each
    batch before pulling the next (a slot overwritten while its copy is in
    flight, or a tensor reused by the allocator, would show here)."""
    from milnce_tpu_torch.config import DataConfig
    from milnce_tpu_torch.data.pipeline import (ShardedLoader,
                                                device_prefetch, stack_batch)
    from milnce_tpu_torch.data.synthetic import SyntheticVideoTextSource

    source = SyntheticVideoTextSource(DataConfig(
        num_frames=8, video_size=64, synthetic_num_samples=40))
    loader = ShardedLoader(source, 4, seed=2, num_threads=4)
    want = [stack_batch(b) for b in loader.epoch(1)]
    copies = []
    for batch in device_prefetch(loader.epoch(1), cuda, depth=depth):
        assert all(t.device.type == "cuda" for t in batch.values())
        copies.append({k: t.clone() for k, t in batch.items()})
    assert len(copies) == len(want) == 10
    for got, host in zip(copies, want):
        for k, arr in host.items():
            assert np.array_equal(got[k].cpu().numpy(), arr), k
