"""Port parity, the step's training variants: the two-pass grad-cache step
(``train.grad_accum``) and ``model.remat``.

From the same numpy-seeded batches and the same JAX-initialized weights
(``flax_to_torch_state_dict`` / ``load_jax_variables``), in float64 on
both sides, with ``tests/test_torch_train.py``'s tolerances (rtol 2e-4,
atol 2e-5):

- the port's grad-cache step at M = 2 against the JAX
  ``make_grad_cache_step`` on a one-device mesh, three steps, MIL-NCE and
  cdtw: losses, parameters, Adam's moments and BatchNorm statistics.
  The oracle is JAX's dense MIL-NCE and scan soft-DTW (its chunked
  sharded parity is red on this tree, and its Pallas soft-DTW backward
  loses the gradient at small gamma: ROADMAP Queue C); the port runs
  its chunked plain stream;
- the same at W = 2 over gloo (``tests/torch_dist_worker.py``) against
  the JAX step on a 2-device mesh, local and sync BatchNorm; and the
  port's M = 2 step against its own W = 2 plain step with local BN on
  the same global batch (a microbatch is a virtual shard);
- the gradients are all-reduced once a step whatever M is, and the loss
  runs once a step on the whole cache;
- the running statistics are the mean of the microbatches' folds of the
  old ones, and ``num_batches_tracked`` advances once a step;
- ``remat`` leaves a step's outputs, gradients, running statistics,
  ``num_batches_tracked`` and ``state_dict`` keys as the plain model's,
  alone, under grad-cache, and over two ranks with sync BatchNorm.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_dist_worker as worker
from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import \
    make_grad_cache_step as jax_make_grad_cache_step
from milnce_tpu_torch.config import LossConfig, OptimConfig
from milnce_tpu_torch.models.s3dg import S3D, BatchNorm3d
from milnce_tpu_torch.train import step as step_module
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_grad_cache_step, make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

torch.set_num_threads(1)         # six test workers share the cores

STEP_RTOL, STEP_ATOL = 2e-4, 2e-5            # tests/test_torch_train.py
_DIMS = dict(num_classes=16, vocab_size=32, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_B, _K, _FRAMES, _SIZE, _WORDS = 8, 2, 4, 32, 5
_M, _STEPS, _WORLD = 2, 3, 2


def _batches(steps=_STEPS):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(70 + i)
        out.append((rng.integers(0, 255, (_B, _FRAMES, _SIZE, _SIZE, 3),
                                 dtype=np.uint8),
                    rng.integers(0, 32, (_B * _K, _WORDS)).astype(np.int64),
                    (rng.random(_B) * 30).astype(np.float32)))
    return out


def _variables():
    variables = JaxS3D(**_DIMS).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
        jnp.zeros((2 * _K, _WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_moments(opt_state) -> dict:
    """Adam's (mu, nu) of the masked JAX optimizer, by torch name."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]

    def trainable(tree):
        return {k: trainable(v) for k, v in tree.items()
                if not isinstance(v, optax.MaskedNode)} \
            if isinstance(tree, dict) else np.asarray(tree)

    mu, nu = (flax_to_torch_state_dict({"params": trainable(dict(t))})
              for t in (adam.mu, adam.nu))
    return {k: (mu[k], nu[k]) for k in mu}


def _jax_grad_cache_run(variables, batches, loss, world=1, sync_bn=False):
    """The JAX grad-cache step at M = 2 on a ``world``-device mesh in
    float64: dense MIL-NCE or scan soft-DTW, the finite guard on."""
    with jax.enable_x64(True):
        model = JaxS3D(dtype=jnp.float64,
                       bn_axis_name="data" if sync_bn else None, **_DIMS)
        opt_cfg = JaxOptimConfig(warmup_steps=2)
        opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
        state = create_train_state(jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables), opt)
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        step = jax_make_grad_cache_step(
            model, opt, mesh, _M, donate=False,
            loss_cfg=JaxLossConfig(name=loss, milnce_impl="dense",
                                   sdtw_backend="scan"),
            finite_guard=True)
        losses, skips = [], []
        for video, text, start in batches:
            state, value, skipped = step(state, video, text.astype(np.int32),
                                         start)
            losses.append(float(value))
            skips.append(int(skipped))
        sd = flax_to_torch_state_dict({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})
        moments = _jax_moments(state.opt_state)
    return losses, skips, sd, moments


def _assert_same(got_state, got_moments, want_state, want_moments):
    keys = [k for k in want_state if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in got_state
                         if not k.endswith("num_batches_tracked")}
    for key in keys:
        np.testing.assert_allclose(got_state[key], want_state[key], STEP_RTOL,
                                   STEP_ATOL, err_msg=key)
    assert set(got_moments) == set(want_moments)
    for key, (mu, nu) in want_moments.items():
        np.testing.assert_allclose(got_moments[key][0], mu, STEP_RTOL,
                                   STEP_ATOL, err_msg=f"exp_avg {key}")
        np.testing.assert_allclose(got_moments[key][1], nu, STEP_RTOL,
                                   STEP_ATOL, err_msg=f"exp_avg_sq {key}")


@pytest.fixture(scope="module")
def inputs():
    return _variables(), _batches()


_RANK_CASES = {("milnce", False): ("milnce", _M, False, False),
               ("milnce", True): ("milnce", _M, True, False),
               ("cdtw", False): ("cdtw", _M, False, False),
               ("cdtw", True): ("cdtw", _M, True, False),
               ("milnce", "sync-remat"): ("milnce", _M, True, True),
               ("milnce", "plain"): ("milnce", 1, False, False),
               ("milnce", "m4"): ("milnce", 4, False, False)}


@pytest.fixture(scope="module")
def rank_runs(inputs, tmp_path_factory):
    """The port's W = 2 runs, in one spawn: grad-cache at M = 2 with local
    and sync BN for both losses, sync BN with remat, M = 4, and the plain
    step with local BN."""
    variables, batches = inputs
    results = worker.spawn(worker.grad_cache_runs, _WORLD,
                           tmp_path_factory.mktemp("gc-ranks"), _DIMS,
                           variables, batches, _RANK_CASES)
    return {label: [r[label] for r in results] for label in _RANK_CASES}


def _one_process(variables, batches, loss, micro_batches=_M):
    return worker.grad_cache_run(0, 1, None, _DIMS, variables, batches, loss,
                                 micro_batches)


def _same_on_every_rank(results):
    (l0, s0, st0, mo0, calls0), *rest = results
    for losses, skips, state, _, calls in rest:
        assert losses == l0 and skips == s0 and calls == calls0
        for key, val in st0.items():
            np.testing.assert_array_equal(state[key], val, err_msg=key)
    return results[0]


# ----------------------------------------------------------- one process
@pytest.mark.parametrize("loss", ["milnce", "cdtw"])
def test_grad_cache_step_matches_jax(loss, inputs):
    variables, batches = inputs
    jl, js, jsd, jmom = _jax_grad_cache_run(variables, batches, loss)
    tl, ts, tsd, tmom, _ = _one_process(variables, batches, loss)
    assert js == ts == [0] * _STEPS
    np.testing.assert_allclose(tl, jl, STEP_RTOL, STEP_ATOL)
    _assert_same(tsd, tmom, jsd, jmom)
    assert all(int(v) == _STEPS for k, v in tsd.items()
               if k.endswith("num_batches_tracked"))


# ----------------------------------------------------------- two ranks
@pytest.mark.parametrize("sync", [False, True], ids=["local-bn", "sync-bn"])
@pytest.mark.parametrize("loss", ["milnce", "cdtw"])
def test_grad_cache_over_two_ranks_matches_the_jax_mesh_step(loss, sync,
                                                            inputs,
                                                            rank_runs):
    variables, batches = inputs
    losses, skips, state, moments, calls = _same_on_every_rank(
        rank_runs[loss, sync])
    jl, js, jsd, jmom = _jax_grad_cache_run(variables, batches, loss,
                                            world=_WORLD, sync_bn=sync)
    if loss == "milnce":
        # The JAX mesh step's MIL-NCE gradients are the mesh size times
        # the gradient of its loss on this jax version (its plain step's
        # too; ROADMAP Queue C, C9): Adam's update hardly sees the scale,
        # so parameters and statistics agree, but its moments carry it.
        # The port's are the one-process gradient on the concatenated
        # batch (tests/test_torch_dist.py); compare them at that scale.
        jmom = {k: (mu / _WORLD, nu / _WORLD ** 2)
                for k, (mu, nu) in jmom.items()}
    assert js == skips == [0] * _STEPS
    np.testing.assert_allclose(losses, jl, STEP_RTOL, STEP_ATOL)
    _assert_same(state, moments, jsd, jmom)


def test_microbatches_are_virtual_shards(inputs, rank_runs):
    """One process at M = 2 is the W = 2 plain step with local BN on the
    same global batch: each microbatch normalizes alone, as a rank does,
    and the statistics are averaged over both."""
    variables, batches = inputs
    tl, ts, tsd, tmom, _ = _one_process(variables, batches, "milnce")
    losses, skips, state, moments, _ = _same_on_every_rank(
        rank_runs["milnce", "plain"])
    assert ts == skips == [0] * _STEPS
    np.testing.assert_allclose(tl, losses, STEP_RTOL, STEP_ATOL)
    _assert_same(tsd, tmom, state, moments)


@pytest.mark.parametrize("case", ["plain", False, "m4"],
                         ids=["m1", "m2", "m4"])
def test_gradients_are_reduced_once_a_step(case, rank_runs):
    """Whatever M, each step all-reduces the gradients once (every
    trainable element in one call) and the running statistics once,
    never a microbatch at a time (the JAX step's
    ``scan-reduction-free`` invariant)."""
    calls = _same_on_every_rank(rank_runs["milnce", case])[4]
    model = S3D(**_DIMS)
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    stats = sum(b.numel() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    assert len(calls) == _STEPS
    assert all(c == [trainable, stats] for c in calls)


def test_the_loss_runs_once_a_step_on_the_whole_cache(inputs, monkeypatch):
    """The MIL-NCE loss (the stream kernels on the card) runs once a step,
    on all B clips and B·K captions: M times fewer launches than a loss a
    microbatch."""
    variables, batches = inputs
    seen = []
    real = step_module.build_milnce_loss

    def counting(cfg, group=None):
        fn = real(cfg, group)

        def loss(v, t):
            seen.append((tuple(v.shape), tuple(t.shape)))
            return fn(v, t)

        return loss

    monkeypatch.setattr(step_module, "build_milnce_loss", counting)
    _one_process(variables, batches, "milnce", micro_batches=4)
    assert seen == [((_B, 16), (_B * _K, 16))] * _STEPS


@pytest.mark.parametrize("micro_batches", [2, 4])
def test_running_stats_are_the_mean_of_the_folds(micro_batches, inputs):
    """After one step: each BatchNorm's running mean and variance are the
    mean over the microbatches of each one's fold into the OLD statistics
    (the JAX step's ``mean(stats_mb)``), not M chained folds, and pass 2
    folded nothing; ``num_batches_tracked`` is 1."""
    variables, batches = inputs
    video, text, start = (torch.from_numpy(x) for x in batches[0])
    base = load_jax_variables(S3D(**_DIMS).to(torch.float64), variables)
    with torch.no_grad():                  # statistics worth the name
        for name, buf in base.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.linspace(-1, 1, buf.numel()))
            elif name.endswith("running_var"):
                buf.copy_(torch.linspace(0.5, 2, buf.numel()))
    model = copy.deepcopy(base)
    optimizer, _ = build_optimizer(model, OptimConfig(), lambda _s: 1e-3)
    make_grad_cache_step(model, optimizer, micro_batches,
                         LossConfig(milnce_impl="dense"))(video, text, start)
    bm = _B // micro_batches
    folds = []
    for m in range(micro_batches):
        ref = copy.deepcopy(base).train()
        with torch.no_grad():
            ref(video[m * bm:(m + 1) * bm].double() / 255.0,
                text[m * bm * _K:(m + 1) * bm * _K])
        folds.append(dict(ref.named_buffers()))
    got = dict(model.named_buffers())
    for name, buf in got.items():
        if name.endswith(("running_mean", "running_var")):
            want = torch.stack([f[name] for f in folds]).mean(0)
            torch.testing.assert_close(buf, want, rtol=1e-12, atol=1e-12)
            chained = folds[0][name]
            assert not torch.allclose(buf, chained, rtol=1e-6, atol=0)
        elif name.endswith("num_batches_tracked"):
            assert int(buf) == 1


def test_grad_cache_refuses_a_batch_it_cannot_split(inputs):
    model = S3D(**_DIMS)
    optimizer, _ = build_optimizer(model, OptimConfig(), lambda _s: 1e-3)
    with pytest.raises(ValueError, match="use make_train_step"):
        make_grad_cache_step(model, optimizer, 1, LossConfig())
    step = make_grad_cache_step(model, optimizer, 3, LossConfig())
    video, text, start = (torch.from_numpy(x) for x in inputs[1][0])
    with pytest.raises(ValueError, match="batch 8 does not split into 3"):
        step(video, text, start)


# ----------------------------------------------------------- remat
def _remat_step(variables, batch, remat, loss, micro_batches):
    model = load_jax_variables(S3D(**_DIMS).to(torch.float64), variables)
    model.remat = remat
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    cfg = LossConfig(name=loss, milnce_impl="dense", sdtw_backend="scan")
    step = (make_grad_cache_step(model, optimizer, micro_batches, cfg,
                                 lr_scheduler=sched)
            if micro_batches > 1 else
            make_train_step(model, optimizer, cfg, lr_scheduler=sched))
    video, text, start = (torch.from_numpy(x) for x in batch)
    out = model.train()(video.double() / 255.0, text)
    value = step(video, text, start)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return out, value, grads, model.state_dict()


@pytest.mark.parametrize("micro_batches", [1, 2], ids=["plain", "grad-cache"])
@pytest.mark.parametrize("loss", ["milnce", "cdtw"])
def test_remat_changes_nothing_a_step_computes(loss, micro_batches, inputs):
    """The checkpointed blocks recompute their forward in the backward;
    the recomputation folds nothing, so running statistics and
    ``num_batches_tracked`` are the plain model's, and the keys carry no
    wrapper prefix."""
    variables, batches = inputs
    plain = _remat_step(variables, batches[0], False, loss, micro_batches)
    remat = _remat_step(variables, batches[0], True, loss, micro_batches)
    for got, want in zip(remat[0], plain[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(remat[1], plain[1], rtol=0, atol=0)
    assert set(remat[2]) == set(plain[2])
    for name, g in plain[2].items():
        torch.testing.assert_close(remat[2][name], g, rtol=1e-12, atol=1e-14)
    assert list(remat[3]) == list(plain[3])
    for key, val in plain[3].items():
        torch.testing.assert_close(remat[3][key], val, rtol=1e-12,
                                   atol=1e-14, msg=key)
    norms = [m for m in S3D(**_DIMS).modules() if isinstance(m, BatchNorm3d)]
    tracked = [v for k, v in remat[3].items()
               if k.endswith("num_batches_tracked")]
    # the extra forward above and the step's one fold
    assert len(tracked) == len(norms) and all(int(v) == 2 for v in tracked)


def test_remat_composes_with_grad_cache_and_sync_batchnorm(rank_runs):
    """Two ranks, sync BN, M = 2: remat's recomputation syncs again but
    folds nothing; every state tensor, Adam's moments and the losses are
    the run's without remat."""
    want = _same_on_every_rank(rank_runs["milnce", True])
    got = _same_on_every_rank(rank_runs["milnce", "sync-remat"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    for key, val in want[2].items():
        np.testing.assert_allclose(got[2][key], val, rtol=1e-10, atol=1e-12,
                                   err_msg=key)
    for key, (mu, nu) in want[3].items():
        np.testing.assert_allclose(got[3][key][0], mu, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got[3][key][1], nu, rtol=1e-10, atol=1e-18)
