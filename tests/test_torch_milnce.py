"""Port parity, loss: the torch dense MIL-NCE and the chunked MIL-NCE on
the plain stream (``milnce_stream_plain``) against the JAX package's
``milnce_loss`` and ``milnce_loss_chunked(backend='pallas')``, whose
Pallas kernels run in interpret mode here.

Same inputs (numpy, seeded) on both sides; the JAX chunked-loss file's
tolerances: ``rtol=2e-6`` on the value, ``atol=2e-6`` on the gradients.
Covered: K in {1, 5}, an uneven last chunk, a batch off the 8-row grid,
and chunk >= Bg; and past the kernels' held depth (D = 1000, 1024), the
plain stream against ``milnce_loss_chunked(backend='scan')``, the stream
JAX's ``auto`` takes at a depth its Pallas kernel cannot hold; and the
plain forward and backward with their logits summed over the deep
paths' depth parts (``deep_parts``, the kernels' order) against the JAX
Pallas stream in interpret mode at D = 769, 1024 and 4608.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); here the wrappers must refuse CPU tensors rather
than compute anything, and the launch plans are checked as pure
functions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from milnce_tpu.losses.milnce import milnce_loss as jax_milnce_loss
from milnce_tpu.losses.milnce_chunked import \
    milnce_loss_chunked as jax_milnce_loss_chunked
from milnce_tpu.ops.milnce_pallas import milnce_stream_pallas
from milnce_tpu_torch.config import LossConfig
from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.losses.milnce_chunked import (build_milnce_loss,
                                                    milnce_default_chunk,
                                                    milnce_loss_chunked,
                                                    prefers_chunked)
from milnce_tpu_torch.ops import milnce_stream as ms

torch.set_num_threads(1)         # six test workers share the cores

_CASES = [(8, 1, 16, 4), (8, 5, 16, 4), (8, 5, 16, 5), (6, 5, 16, 4),
          (8, 5, 16, 8), (8, 5, 16, 64)]
_IDS = ["k1", "k5", "uneven", "uneven-b6", "chunk-eq-bg", "chunk-gt-bg"]


def _embeddings(b, k, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            rng.randn(b * k, d).astype(np.float32))


def _torch_value_and_grads(fn, v, t):
    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    loss = fn(tv, tt)
    loss.backward()
    return float(loss.detach()), tv.grad.numpy(), tt.grad.numpy()


def _check(got, want):
    val, gv, gt = got
    wval, (wgv, wgt) = want
    np.testing.assert_allclose(val, float(wval), rtol=2e-6)
    np.testing.assert_allclose(gv, np.asarray(wgv), atol=2e-6)
    np.testing.assert_allclose(gt, np.asarray(wgt), atol=2e-6)


@pytest.mark.parametrize("b,k,d,chunk", _CASES, ids=_IDS)
def test_dense_loss_matches_jax(b, k, d, chunk):
    v, t = _embeddings(b, k, d, seed=b * 10 + k + chunk)
    want = jax.value_and_grad(jax_milnce_loss, argnums=(0, 1))(
        jnp.asarray(v), jnp.asarray(t))
    _check(_torch_value_and_grads(milnce_loss, v, t), want)


@pytest.mark.parametrize("b,k,d,chunk", _CASES, ids=_IDS)
def test_chunked_plain_stream_matches_jax_pallas(b, k, d, chunk):
    v, t = _embeddings(b, k, d, seed=b * 10 + k + chunk)
    want = jax.value_and_grad(
        lambda a, c: jax_milnce_loss_chunked(a, c, chunk=chunk,
                                             backend="pallas"),
        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(t))
    got = _torch_value_and_grads(
        lambda a, c: milnce_loss_chunked(a, c, chunk=chunk, backend="scan"),
        v, t)
    _check(got, want)


@pytest.mark.parametrize("b,bg,k,chunk", [(3, 7, 2, 3), (4, 9, 1, 4)],
                         ids=["k2", "k1"])
def test_plain_primitives_against_dense_autograd(b, bg, k, chunk):
    """The plain stream with local rows distinct from the gathered
    negatives (the multi-device layout): values and the four gradients
    against autograd through the dense logsumexps."""
    rng = np.random.RandomState(b + bg)
    arrays = [rng.randn(n, 8).astype(np.float32)
              for n in (b, b * k, bg, bg * k)]
    g_row = torch.from_numpy(rng.randn(b).astype(np.float32))
    g_col = torch.from_numpy(rng.randn(b * k).astype(np.float32))

    def run(stream):
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        row, col = stream(*leaves)
        grads = torch.autograd.grad((row, col), leaves, (g_row, g_col))
        return [row.detach(), col.detach(), *grads]

    def dense(v, t, v_all, t_all):
        return (torch.logsumexp(v @ t_all.T, 1),
                torch.logsumexp(t @ v_all.T, 1))

    got = run(lambda *x: ms.milnce_stream_plain(*x, chunk))
    want = run(dense)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("b,k,d,chunk", [(8, 5, 1024, 3), (6, 3, 1000, 4)],
                         ids=["d1024", "d1000"])
def test_plain_stream_past_the_held_depth_matches_jax_scan(b, k, d, chunk):
    """C6: past STREAM_DMAX (where the card runs the kernels' deep mode)
    the plain stream equals JAX's scan stream, the one JAX's ``auto``
    takes there (``prefers_pallas`` is false); the same tolerances."""
    assert d > ms.STREAM_DMAX
    v, t = _embeddings(b, k, d, seed=d + b)
    v, t = v * d ** -0.25, t * d ** -0.25          # logits of unit scale
    want = jax.value_and_grad(
        lambda a, c: jax_milnce_loss_chunked(a, c, chunk=chunk,
                                             backend="scan"),
        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(t))
    got = _torch_value_and_grads(
        lambda a, c: milnce_loss_chunked(a, c, chunk=chunk, backend="scan"),
        v, t)
    _check(got, want)


def test_auto_stream_takes_the_plain_path_for_cpu_tensors():
    v, t = _embeddings(4, 2, 8, seed=1)
    ms.reset_launches()
    auto = milnce_loss_chunked(torch.from_numpy(v), torch.from_numpy(t),
                               chunk=3, backend="auto")
    scan = milnce_loss_chunked(torch.from_numpy(v), torch.from_numpy(t),
                               chunk=3, backend="scan")
    assert float(auto) == float(scan)
    assert all(n == 0 for n in ms.LAUNCHES.values())


@pytest.mark.parametrize("kernel", [ms.lse_fwd, ms.lse_bwd_rows,
                                    ms.lse_bwd_cols],
                         ids=["lse_fwd", "lse_bwd_rows", "lse_bwd_cols"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    a, b = torch.zeros(4, 8), torch.zeros(6, 8)
    args = (a, b) if kernel is ms.lse_fwd else (a, b, torch.zeros(4),
                                                torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        milnce_loss_chunked(torch.zeros(2, 8), torch.zeros(4, 8),
                            backend="cuda")


def test_default_chunk_rule_and_auto_impl_rule():
    assert milnce_default_chunk(4, 1, 4) == 4
    c = milnce_default_chunk(128, 5, 8192)
    assert c % 8 == 0 and 8 <= c <= 8192
    assert not prefers_chunked(16, 16, 5)
    assert prefers_chunked(128, 8192, 5)


def test_build_milnce_loss_knobs():
    with pytest.raises(ValueError, match="milnce_impl"):
        build_milnce_loss(LossConfig(milnce_impl="streamed"))
    with pytest.raises(ValueError, match="milnce_backend"):
        build_milnce_loss(LossConfig(milnce_impl="chunked",
                                     milnce_backend="pallas"))
    v, t = (torch.from_numpy(x) for x in _embeddings(4, 2, 8, seed=2))
    dense = float(build_milnce_loss(None)(v, t))
    assert dense == pytest.approx(float(milnce_loss(v, t)), rel=1e-7)
    chunked = build_milnce_loss(LossConfig(milnce_impl="chunked",
                                           milnce_chunk=3))(v, t)
    assert float(chunked) == pytest.approx(dense, rel=2e-6)
    # no group is the one-process loss exactly (ranks: test_torch_dist.py)
    assert torch.equal(build_milnce_loss(None, group=None)(v, t),
                       milnce_loss(v, t))


def _bwd_instance(d):
    """(dmax, mode, nz) a backward plan must take at depth d: held up to
    STREAM_DMAX, the cluster path (parts of <= 512, <= 8 of them) up to
    CLUSTER_REACH, the slab path (gradient slabs of 768) past it."""
    if d > ms.CLUSTER_REACH:
        return ms.STREAM_DMAX, "deep_slab", -(-d // ms.STREAM_DMAX)
    if d > ms.STREAM_DMAX:
        return ms.CLUSTER_DMAX, "deep", -(-d // ms.CLUSTER_DMAX)
    return min(x for x in ms.ROWS_INSTANCES if d <= x), "held", 1


def _one_wave(plan):
    """One wave: of the card's resident clusters on the cluster path, of
    one block an SM (132) otherwise, unless the owned tiles alone pass
    it."""
    if plan.mode == "deep":
        assert plan.clusters == ms.H100_CLUSTERS[plan.nz]
        assert (plan.row_tiles * plan.nsplit
                <= max(plan.clusters, plan.row_tiles))
        return plan.row_tiles >= plan.clusters
    blocks = plan.row_tiles * plan.nz
    assert blocks * plan.nsplit <= max(132, blocks)
    return blocks >= 132


_BWD_DEPTHS = [13, 512, 700, 769, 1000, 1024, 2048, 4096, 4097]


@pytest.mark.parametrize("r", [1, 33, 128, 640])
@pytest.mark.parametrize("c", [1, 80, 8191, 40960])
@pytest.mark.parametrize("d", _BWD_DEPTHS)
def test_rows_launch_plan_covers_every_column_tile_once(r, c, d):
    plan = ms.rows_plan(r, c, d, sms=132)
    assert (plan.dmax, plan.mode, plan.nz) == _bwd_instance(d)
    assert (plan.bm, plan.bn, plan.threads) == (32, 256, 256)
    assert plan.row_tiles == -(-r // 32) and plan.col_tiles == -(-c // 256)
    covered = [t for s in range(plan.nsplit) for t in plan.tiles(s)]
    assert sorted(covered) == list(range(plan.col_tiles))
    assert all(len(plan.tiles(s)) > 0 for s in range(plan.nsplit))
    assert max(len(plan.tiles(s)) for s in range(plan.nsplit)) == plan.tps
    assert plan.scratch == (plan.nsplit, r, d)
    _one_wave(plan)
    assert plan.smem_bytes <= 232448


def test_rows_launch_plan_shapes_and_refusal():
    recipe = ms.rows_plan(128, 40960, 512, sms=132)
    assert (recipe.nsplit, recipe.tps, recipe.dmax) == (32, 5, 512)
    assert ms.rows_plan(640, 8192, 512, sms=132).nsplit == 6
    assert ms.rows_plan(1, 1, 1, sms=132).nsplit == 1
    # the row tiles alone fill the card: no split
    assert ms.rows_plan(32 * 200, 40960, 512, sms=132).nsplit == 1
    # past the largest held instance: the deep mode, not a refusal
    held = ms.rows_plan(4, 8, 768, sms=132)
    assert (held.dmax, held.mode, held.nz) == (768, "held", 1)
    deep = ms.rows_plan(4, 8, 769, sms=132)
    assert (deep.dmax, deep.mode, deep.nz, deep.parts) == (
        512, "deep", 2, ((0, 416), (416, 353)))
    # the recipe's rows launch at D = 1024: 4 row tiles, clusters of 2
    # blocks, 66 of them resident, the streamed loop split to 64 clusters
    recipe = ms.rows_plan(128, 40960, 1024, sms=132)
    assert (recipe.row_tiles, recipe.nz, recipe.clusters, recipe.nsplit,
            recipe.tps, recipe.smem_bytes) == (4, 2, 66, 16, 10, 230208)
    # the held O part, Ws, three stages, lse and g, the partial tile
    assert recipe.smem_bytes == 4 * (32 * 516 + 4 * (8 * 256 + 4)
                                     + 3 * 256 * 32 + 2 * 32 + 32 * 256)
    # the card's own resident count, where it is asked, sizes the wave
    assert ms.rows_plan(128, 40960, 1024, sms=132, clusters=30).nsplit == 7
    # the slab path, kept past the cluster's reach, on request at D = 1024:
    # the logits summed over the same parts, the finished parts' tile
    slab = ms.rows_plan(128, 40960, 1024, sms=132, slab=True)
    assert (slab.dmax, slab.mode, slab.nz, slab.nsplit, slab.tps,
            slab.smem_bytes, slab.parts) == (768, "deep_slab", 2, 16, 10,
                                             176448, recipe.parts)
    assert slab.smem_bytes == 4 * (4 * (8 * 256 + 4) + 3 * (256 + 32) * 32
                                   + 2 * 32 + 32 * 256)


def _pad(r, sn):
    return -(-r // sn) * sn - r


@pytest.mark.parametrize("r", [1, 33, 128, 200, 640, 2048])
@pytest.mark.parametrize("c", [1, 40, 8191, 40960])
@pytest.mark.parametrize("d", _BWD_DEPTHS)
def test_cols_launch_plan_covers_every_streamed_tile_once(r, c, d):
    plan = ms.cols_plan(r, c, d, sms=132)
    assert (plan.dmax, plan.mode, plan.nz) == _bwd_instance(d)
    assert (plan.bm, plan.threads) == (32, 256)
    # 128-row streamed tiles: a 256-row tile never pads A less
    assert plan.bn == 128
    assert _pad(r, 128) <= _pad(r, 256)
    assert plan.row_tiles == -(-c // 32)
    assert plan.col_tiles == -(-r // plan.bn)
    covered = [t for s in range(plan.nsplit) for t in plan.tiles(s)]
    assert sorted(covered) == list(range(plan.col_tiles))
    assert all(len(plan.tiles(s)) > 0 for s in range(plan.nsplit))
    assert max(len(plan.tiles(s)) for s in range(plan.nsplit)) == plan.tps
    assert plan.scratch == (plan.nsplit, c, d)
    # one wave unless the owned tiles alone pass it, and then no split
    if _one_wave(plan):
        assert plan.nsplit == 1
    assert plan.smem_bytes <= 232448


def test_cols_launch_plan_shapes_and_refusal():
    # the two launches of a step at the recipe shape: no split, no padding
    rows_call = ms.cols_plan(128, 40960, 512, sms=132)
    assert (rows_call.bn, rows_call.row_tiles, rows_call.col_tiles,
            rows_call.nsplit) == (128, 1280, 1, 1)
    cols_call = ms.cols_plan(640, 8192, 512, sms=132)
    assert (cols_call.bn, cols_call.row_tiles, cols_call.col_tiles,
            cols_call.nsplit) == (128, 256, 5, 1)
    # few owned tiles: the streamed loop splits, one tile a split
    split = ms.cols_plan(2048, 40, 512, sms=132)
    assert (split.bn, split.row_tiles, split.nsplit, split.tps) == (128, 2,
                                                                     16, 1)
    assert ms.cols_plan(256, 8, 512, sms=132).bn == 128
    # 128-row streamed tiles take less shared memory than 256-row ones
    assert (ms.cols_plan(8, 8, 512, sms=132).smem_bytes
            < ms.rows_plan(8, 8, 512, sms=132).smem_bytes)
    assert ms.cols_plan(4, 8, 768, sms=132).mode == "held"
    deep = ms.cols_plan(4, 8, 769, sms=132)
    assert (deep.dmax, deep.mode, deep.nz, deep.smem_bytes) == (
        512, "deep", 2, 4 * (32 * 516 + 4 * (8 * 128 + 4) + 3 * 128 * 32
                             + 2 * 32 + 32 * 128))
    slab = ms.cols_plan(4, 8, 769, sms=132, slab=True)
    assert (slab.dmax, slab.mode, slab.nz, slab.smem_bytes, slab.parts) == (
        768, "deep_slab", 2, 4 * (4 * (8 * 128 + 4) + 3 * 8 * 768 + 2 * 32
                                  + 32 * 128), deep.parts)


@pytest.mark.parametrize("d", [769, 1000, 1024, 2048, 4096, 4097])
def test_deep_backward_parts_and_plans(d):
    """The deep backward at depth d: its depth parts cover 0 .. d - 1
    once, each a multiple of 32 but the last and none past 512; up to
    CLUSTER_REACH the cluster path in clusters of at most 8 blocks, past
    it the slab path; both within the opt-in shared memory at both tile
    widths; the recipe's launches in one wave of the H100's resident
    clusters."""
    parts = ms.deep_parts(d)
    assert parts[0][0] == 0
    assert all(k0 + w == k1 for (k0, w), (k1, _) in zip(parts, parts[1:]))
    assert parts[-1][0] + parts[-1][1] == d
    assert all(w % 32 == 0 for _, w in parts[:-1])
    assert all(0 < w <= ms.CLUSTER_DMAX for _, w in parts)
    assert len({w for _, w in parts[:-1]}) <= 1
    assert len(parts) == -(-d // 512)
    for plan_of in (ms.rows_plan, ms.cols_plan):
        for r, c in ((128, 40960), (640, 8192)):
            plan = plan_of(r, c, d, sms=132)
            assert (plan.dmax, plan.mode, plan.nz) == _bwd_instance(d)
            assert plan.smem_bytes <= 232448
            # both deep paths sum the logits over the same parts
            assert plan.parts == tuple(parts)
            if d <= ms.CLUSTER_REACH:
                assert plan.nz <= 8
                assert plan.clusters == ms.H100_CLUSTERS[plan.nz]
            else:
                assert plan.clusters == 0
            _one_wave(plan)
            slab = plan_of(r, c, d, sms=132, slab=True)
            assert (slab.mode, slab.dmax) == ("deep_slab", 768)
            assert slab.parts == tuple(parts)
            assert slab.smem_bytes <= 232448
    for name in ms.KERNELS:
        assert ms.launch_key(name, d) == (
            f"{name}_deep" if d <= 4096 else f"{name}_deep_slab")


def test_row_sum_renormalization_recovers_the_gradient():
    """The identity the CUDA stream's backward rests on, on the cluster
    path, where the backward's logits round unlike the forward's: with an
    lse off by delta, dividing the rows' gradient by the row sums s_r =
    sum_j exp(x_rj - lse_r), and the cols' g by the same s, gives the
    gradients of the true logsumexp (the plain twins, which compute in
    f32: rtol and atol 1e-6)."""
    rng = np.random.RandomState(7)
    a, b = (torch.from_numpy(rng.randn(n, 40)) for n in (6, 11))
    g = torch.from_numpy(rng.randn(6))
    lse = torch.logsumexp(a @ b.T, dim=1)
    off = lse + torch.from_numpy(rng.randn(6) * 0.3)
    s = torch.exp(a @ b.T - off[:, None]).sum(dim=1)
    rows = ms.lse_bwd_rows_plain(a, b, off, g, 4)
    cols = ms.lse_bwd_cols_plain(a, b, off, g / s, 4)
    torch.testing.assert_close(rows.double() / s[:, None],
                               ms.lse_bwd_rows_plain(a, b, lse, g, 4).double(),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(cols.double(),
                               ms.lse_bwd_cols_plain(a, b, lse, g, 4).double(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [769, 1024, 4608])
def test_partwise_plain_matches_jax_pallas_stream(d):
    """The plain forward and backward with the logits summed part by part
    in rank order (the deep paths' arithmetic, :func:`deep_parts`: 2
    parts, and at D = 4608, past the cluster path's reach, the slab
    path's 9) against the JAX package's ``milnce_stream_pallas``
    (interpret mode): values and the four gradients, local rows apart
    from the gathered ones, an uneven last chunk; the JAX chunked-loss
    tolerances (rtol 2e-6 on the values, atol 2e-6 on the gradients)."""
    b, bg, k, chunk = 4, 8, 3, 3
    rng = np.random.RandomState(d)
    v, t, v_all, t_all = (rng.randn(n, d).astype(np.float32) * d ** -0.25
                          for n in (b, b * k, bg, bg * k))
    g_row = rng.randn(b).astype(np.float32)
    g_col = rng.randn(b * k).astype(np.float32)
    (row, col), vjp = jax.vjp(
        lambda *x: milnce_stream_pallas(*x, chunk),
        *map(jnp.asarray, (v, t, v_all, t_all)))
    want = vjp((jnp.asarray(g_row), jnp.asarray(g_col)))
    tv, tt, tva, tta = map(torch.from_numpy, (v, t, v_all, t_all))
    gr, gc = torch.from_numpy(g_row), torch.from_numpy(g_col)
    ck, parts = chunk * k, ms.deep_parts(d)
    assert len(parts) == -(-d // 512) and len(parts) in (2, 9)
    trow = ms.lse_plain(tv, tta, ck, parts)
    tcol = ms.lse_plain(tt, tva, chunk, parts)
    got = (ms.lse_bwd_rows_plain(tv, tta, trow, gr, ck, parts),
           ms.lse_bwd_rows_plain(tt, tva, tcol, gc, chunk, parts),
           ms.lse_bwd_cols_plain(tt, tva, tcol, gc, chunk, parts),
           ms.lse_bwd_cols_plain(tv, tta, trow, gr, ck, parts))
    np.testing.assert_allclose(trow.numpy(), np.asarray(row), rtol=2e-6)
    np.testing.assert_allclose(tcol.numpy(), np.asarray(col), rtol=2e-6)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-6)


def _fwd_instance(d):
    """(dmax, mode, nz, (bm, bn)) a forward plan must take at depth d: the
    held instances up to STREAM_DMAX, the cluster path (parts of <= 512,
    <= 8 of them, in 32 x 256 tiles) up to CLUSTER_REACH,
    the slab path (the 768 instance's tiles, one block a (row tile,
    split)) past it."""
    if d > ms.CLUSTER_REACH:
        return ms.STREAM_DMAX, "deep_slab", 1, (32, 256)
    if d > ms.STREAM_DMAX:
        return ms.CLUSTER_DMAX, "deep", -(-d // ms.CLUSTER_DMAX), (32, 256)
    dmax = min(x for x in ms.ROWS_INSTANCES if d <= x)
    return dmax, "held", 1, ms.FWD_TILES[dmax]


@pytest.mark.parametrize("r", [1, 33, 64, 128, 200, 640, 2048])
@pytest.mark.parametrize("c", [1, 40, 257, 8191, 40960])
@pytest.mark.parametrize("d", [13, 512, 700, 768, 1000, 2048, 4096, 4097])
def test_fwd_launch_plan_covers_every_tile_once(r, c, d):
    plan = ms.fwd_plan(r, c, d, sms=132)
    assert (plan.dmax, plan.mode, plan.nz, (plan.bm, plan.bn)) == (
        _fwd_instance(d))
    assert plan.threads == 256
    # 256 threads, each 8 owned rows by 4 streamed rows
    assert plan.bm * plan.bn // plan.threads == 32
    # every owned row once: the last owned tile holds the last row
    assert plan.row_tiles == -(-r // plan.bm)
    assert (plan.row_tiles - 1) * plan.bm < r <= plan.row_tiles * plan.bm
    # every streamed tile once, in non-empty splits
    assert plan.col_tiles == -(-c // plan.bn)
    covered = [t for s in range(plan.nsplit) for t in plan.tiles(s)]
    assert sorted(covered) == list(range(plan.col_tiles))
    assert all(len(plan.tiles(s)) > 0 for s in range(plan.nsplit))
    assert max(len(plan.tiles(s)) for s in range(plan.nsplit)) == plan.tps
    assert plan.scratch == (plan.nsplit, r)
    _one_wave(plan)
    assert plan.smem_bytes <= 232448
    assert plan.parts == (() if plan.mode == "held"
                          else tuple(ms.deep_parts(d)))


@pytest.mark.parametrize("d", [769, 1000, 1024, 2048, 4096, 4097, 4608])
def test_fwd_deep_paths_plans(d):
    """The forward past STREAM_DMAX: up to CLUSTER_REACH clusters of nz =
    len(deep_parts(d)) blocks, each holding its part (at most 512 deep) of
    32 owned rows beside the ring of 256-row streamed tiles and a (32,
    256) tile of partial logits, the wave the card's resident clusters (the H100's
    where no card is asked, the count given where it is); ``slab`` gives
    the slab path, past CLUSTER_REACH the only one, summing the logits
    over the same parts."""
    parts = tuple(ms.deep_parts(d))
    for r, c in ((128, 40960), (640, 8192), (4, 8)):
        slab = ms.fwd_plan(r, c, d, sms=132, slab=True)
        assert (slab.dmax, slab.mode, slab.nz, slab.bm, slab.bn,
                slab.parts, slab.clusters) == (768, "deep_slab", 1, 32, 256,
                                               parts, 0)
        assert slab.smem_bytes == 4 * (3 * (256 + 32) * 32 + 32 * 256)
        plan = ms.fwd_plan(r, c, d, sms=132)
        if d > ms.CLUSTER_REACH:
            assert plan == slab
            continue
        nz = len(parts)
        assert (plan.dmax, plan.mode, plan.nz, plan.bm, plan.bn, plan.parts,
                plan.clusters) == (512, "deep", nz, 32, 256, parts,
                                   ms.H100_CLUSTERS[nz])
        assert plan.smem_bytes == 4 * (32 * 516 + 3 * 256 * 32 + 32 * 256)
        assert plan.smem_bytes == 197120
        assert plan.row_tiles * plan.nsplit <= max(plan.clusters,
                                                   plan.row_tiles)
        asked = ms.fwd_plan(r, c, d, sms=132, clusters=7)
        assert asked.clusters == 7
        assert asked.row_tiles * asked.nsplit <= max(7, asked.row_tiles)
    # the deep recipe's two launches at D = 1024: clusters of 2 blocks,
    # 66 resident, 64 and 60 of them in the one wave
    if d == 1024:
        rows_call = ms.fwd_plan(128, 40960, d, sms=132)
        assert (rows_call.row_tiles, rows_call.col_tiles, rows_call.nsplit,
                rows_call.tps) == (4, 160, 16, 10)
        cols_call = ms.fwd_plan(640, 8192, d, sms=132)
        assert (cols_call.row_tiles, cols_call.col_tiles, cols_call.nsplit,
                cols_call.tps) == (20, 32, 3, 11)


def test_forward_modes_launch_keys():
    """Each forward mode counts under its own key, as the backward's do:
    ``lse_fwd`` held, ``lse_fwd_deep`` on the cluster path up to
    CLUSTER_REACH, ``lse_fwd_deep_slab`` past it."""
    assert {k for k in ms.LAUNCHES if k.startswith("lse_fwd")} == {
        f"lse_fwd{m}{e}" for m in ("", "_deep", "_deep_slab")
        for e in ("", "_bf16")}
    for d, key in ((768, "lse_fwd"), (769, "lse_fwd_deep"),
                   (4096, "lse_fwd_deep"), (4097, "lse_fwd_deep_slab"),
                   (4608, "lse_fwd_deep_slab")):
        assert ms.launch_key("lse_fwd", d) == key
        plan = ms.fwd_plan(4, 8, d, sms=132)
        assert ms._key("lse_fwd", plan.mode, torch.float32) == key
        assert ms.launch_key("lse_fwd", d, torch.bfloat16) == key + "_bf16"
        assert ms._key("lse_fwd", plan.mode, torch.bfloat16) == key + "_bf16"
        if d > ms.STREAM_DMAX:
            assert ms.launch_key("lse_fwd", d, torch.bfloat16, slab=True) == (
                "lse_fwd_deep_slab_bf16")


def test_fwd_launch_plan_shapes_and_refusal():
    # the two launches of a step at the recipe shape
    # (64 x 128 tiles: 640 of them in each, 5 a block on 128 and 130 SMs)
    rows_call = ms.fwd_plan(128, 40960, 512, sms=132)
    assert (rows_call.dmax, rows_call.bm, rows_call.bn, rows_call.row_tiles,
            rows_call.col_tiles, rows_call.nsplit, rows_call.tps,
            rows_call.smem_bytes) == (512, 64, 128, 2, 320, 64, 5, 181248)
    cols_call = ms.fwd_plan(640, 8192, 512, sms=132)
    assert (cols_call.row_tiles, cols_call.col_tiles, cols_call.nsplit,
            cols_call.tps, cols_call.scratch) == (10, 64, 13, 5, (13, 640))
    # chip_smoke's fwd-split case: split owned rows, splits of three
    # tiles, the last of two ending on a ragged tile
    split = ms.fwd_plan(200, 9000, 512, sms=132)
    assert (split.row_tiles, split.col_tiles, split.nsplit, split.tps) == (
        4, 71, 24, 3)
    assert 9000 % 128 and list(split.tiles(23)) == [69, 70]
    # D <= 768 owns 32 rows: 64 would leave no room for the ring
    deep = ms.fwd_plan(33, 2048, 700, sms=132)
    assert (deep.dmax, deep.bm, deep.bn, deep.smem_bytes) == (768, 32, 256,
                                                              197120)
    assert 4 * (64 * 772 + 3 * 128 * 32) > 232448
    assert ms.fwd_plan(4, 8, ms.STREAM_DMAX, sms=132).mode == "held"
    # past it the cluster path: parts of at most 512 in 32 x 256 tiles
    deep = ms.fwd_plan(4, 8, ms.STREAM_DMAX + 1, sms=132)
    assert (deep.dmax, deep.mode, deep.bm, deep.bn, deep.nz, deep.parts) == (
        512, "deep", 32, 256, 2, ((0, 416), (416, 353)))
    # the slab path: the 768 instance's tiles, A streamed beside B in each
    # of the three stages, no A tile held, the finished parts' logits
    slab = ms.fwd_plan(4, 8, ms.STREAM_DMAX + 1, sms=132, slab=True)
    assert (slab.dmax, slab.mode, slab.bm, slab.bn, slab.smem_bytes) == (
        768, "deep_slab", 32, 256, 4 * (3 * (256 + 32) * 32 + 32 * 256))
    with pytest.raises(ValueError, match="lse_fwd: depth 0"):
        ms.fwd_plan(4, 8, 0, sms=132)


def test_stream_refuses_the_depth_before_any_launch():
    """No depth is refused any more: past the largest held instance the
    stream takes the deep mode, so on CPU tensors the only refusal is the
    device's, at every depth, before a forward could launch; the plans
    say which mode a launch would take."""
    ms.reset_launches()
    for d, mode in ((769, "deep"), (768, "held"), (2048, "deep")):
        v, t = torch.zeros(2, d), torch.zeros(4, d)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ms.milnce_stream_cuda(v, t, v, t, 2)
        assert ms.check_depth("milnce_stream_cuda", d)[1] == mode
    assert all(n == 0 for n in ms.LAUNCHES.values())
    assert set(ms.LAUNCHES) == {f"{k}{m}{e}" for k in ms.KERNELS
                                for m in ("", "_deep", "_deep_slab")
                                for e in ("", "_bf16")}
