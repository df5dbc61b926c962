"""Port parity, loss: the torch dense MIL-NCE and the chunked MIL-NCE on
the plain stream (``milnce_stream_plain``) against the JAX package's
``milnce_loss`` and ``milnce_loss_chunked(backend='pallas')``, whose
Pallas kernels run in interpret mode here.

Same inputs (numpy, seeded) on both sides; the JAX chunked-loss file's
tolerances: ``rtol=2e-6`` on the value, ``atol=2e-6`` on the gradients.
Covered: K in {1, 5}, an uneven last chunk, a batch off the 8-row grid,
and chunk >= Bg; and past the kernels' held depth (D = 1000, 1024), the
plain stream against ``milnce_loss_chunked(backend='scan')``, the stream
JAX's ``auto`` takes at a depth its Pallas kernel cannot hold.  The
CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here the wrappers must refuse CPU tensors rather
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


def _instance(d):
    """(dmax, mode, nz) a backward plan must take at depth d."""
    if d > ms.STREAM_DMAX:
        return ms.STREAM_DMAX, "deep", -(-d // ms.STREAM_DMAX)
    return min(x for x in ms.ROWS_INSTANCES if d <= x), "held", 1


@pytest.mark.parametrize("r", [1, 33, 128, 640])
@pytest.mark.parametrize("c", [1, 80, 8191, 40960])
@pytest.mark.parametrize("d", [13, 512, 700, 1000, 2048])
def test_rows_launch_plan_covers_every_column_tile_once(r, c, d):
    plan = ms.rows_plan(r, c, d, sms=132)
    assert (plan.dmax, plan.mode, plan.nz) == _instance(d)
    assert (plan.bm, plan.bn, plan.threads) == (32, 256, 256)
    assert plan.row_tiles == -(-r // 32) and plan.col_tiles == -(-c // 256)
    covered = [t for s in range(plan.nsplit) for t in plan.tiles(s)]
    assert sorted(covered) == list(range(plan.col_tiles))
    assert all(len(plan.tiles(s)) > 0 for s in range(plan.nsplit))
    assert max(len(plan.tiles(s)) for s in range(plan.nsplit)) == plan.tps
    assert plan.scratch == (plan.nsplit, r, d)
    # one wave of one block per SM unless the row tiles (times the deep
    # mode's gradient slabs) alone pass it
    blocks = plan.row_tiles * plan.nz
    assert blocks * plan.nsplit <= max(132, blocks)
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
    assert (deep.dmax, deep.mode, deep.nz) == (768, "deep", 2)
    # the recipe's rows launch at D = 1024: 4 row tiles x 2 gradient
    # slabs, the streamed loop split to fill one wave; no O tile held,
    # the ring's logits stages hold an owned slab beside the streamed one
    recipe = ms.rows_plan(128, 40960, 1024, sms=132)
    assert (recipe.row_tiles, recipe.nz, recipe.nsplit, recipe.tps,
            recipe.smem_bytes) == (4, 2, 16, 10, 143680)
    assert recipe.smem_bytes == 4 * (4 * (8 * 256 + 4) + 3 * (256 + 32) * 32
                                     + 2 * 32)


def _pad(r, sn):
    return -(-r // sn) * sn - r


@pytest.mark.parametrize("r", [1, 33, 128, 200, 640, 2048])
@pytest.mark.parametrize("c", [1, 40, 8191, 40960])
@pytest.mark.parametrize("d", [13, 512, 700, 1000, 2048])
def test_cols_launch_plan_covers_every_streamed_tile_once(r, c, d):
    plan = ms.cols_plan(r, c, d, sms=132)
    assert (plan.dmax, plan.mode, plan.nz) == _instance(d)
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
    # one wave of one block per SM unless the owned tiles (times the deep
    # mode's gradient slabs) alone pass it
    blocks = plan.row_tiles * plan.nz
    assert blocks * plan.nsplit <= max(132, blocks)
    if blocks >= 132:
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
        768, "deep", 2, 4 * (4 * (8 * 128 + 4) + 3 * 8 * 768 + 2 * 32))


@pytest.mark.parametrize("r", [1, 33, 64, 128, 200, 640, 2048])
@pytest.mark.parametrize("c", [1, 40, 257, 8191, 40960])
@pytest.mark.parametrize("d", [13, 512, 700, 768, 1000, 2048])
def test_fwd_launch_plan_covers_every_tile_once(r, c, d):
    plan = ms.fwd_plan(r, c, d, sms=132)
    dmax, mode, _ = _instance(d)
    assert (plan.dmax, plan.mode, plan.nz) == (dmax, mode, 1)
    assert (plan.bm, plan.bn) == ms.FWD_TILES[plan.dmax]
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
    assert plan.row_tiles * plan.nsplit <= max(132, plan.row_tiles)
    assert plan.smem_bytes <= 232448


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
    # past it the deep mode: the same tiles, A streamed beside B in each
    # of the three stages, no A tile held
    deep = ms.fwd_plan(4, 8, ms.STREAM_DMAX + 1, sms=132)
    assert (deep.dmax, deep.mode, deep.bm, deep.bn, deep.smem_bytes) == (
        768, "deep", 32, 256, 4 * 3 * (256 + 32) * 32)
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
    assert set(ms.LAUNCHES) == {f"{k}{m}" for k in ms.KERNELS
                                for m in ("", "_deep")}
