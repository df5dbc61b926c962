"""Port parity, training: three optimizer steps of the torch trainer
against the JAX ``make_train_step`` on a one-device ``Mesh``, from the
same weights and the same batches, for the dense and the chunked loss.

Losses and every parameter and BatchNorm statistic are compared leaf by
leaf with ``rtol=2e-4, atol=2e-5`` (the JAX chunked-loss file's train
tolerance: three Adam steps amplify f32 summation-order differences).
Also pinned: the schedule's pre-increment count (the first warmup step
runs at lr 0 in both), the frozen word table, the finite-guard skip, and
the ``milnce-train-torch`` entry point on the CPU.
"""

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.resilience import faults
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import make_train_step as jax_make_train_step
from milnce_tpu_torch.config import LossConfig, OptimConfig
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.train.schedule import build_schedule, cosine_with_warmup
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
_B, _K, _FRAMES, _SIZE, _WORDS, _VOCAB = 4, 2, 4, 32, 5, 32
_DIMS = dict(num_classes=16, vocab_size=_VOCAB, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_STEPS = 3


def _batch(i):
    rng = np.random.default_rng(i)
    video = rng.integers(0, 255, (_B, _FRAMES, _SIZE, _SIZE, 3),
                         dtype=np.uint8)
    text = rng.integers(0, _VOCAB, (_B * _K, _WORDS)).astype(np.int32)
    return video, text


def _variables():
    variables = JaxS3D(**_DIMS).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
        jnp.zeros((2 * _K, _WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_run(loss_cfg, poison=""):
    """The JAX step from the f32 init, computed in float64.

    Both sides compare leaf by leaf in float64 (the MIL-NCE stream still
    runs in f32 on both, as the JAX scan upcasts/downcasts to f32).  In
    f32 two things break a leaf-by-leaf comparison at this tiny size:
    the JAX BatchNorm's one-pass variance (E[x^2] - E[x]^2) loses ~1e-2
    of some gradients, where the port's two-pass f32 BatchNorm stays
    within ~4e-6 of float64 (ROADMAP.md Queue C); and Adam scales a
    near-zero gradient up to a full lr-sized step, so its last-bit noise
    moves that parameter by a visible fraction of lr."""
    variables = _variables()
    with jax.enable_x64(True), (faults.armed(poison) if poison
                                else contextlib.nullcontext()):
        model = JaxS3D(dtype=jnp.float64, **_DIMS)
        state_vars = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables)
        opt_cfg = JaxOptimConfig(warmup_steps=2)
        opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
        state = create_train_state(state_vars, opt)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        step = jax_make_train_step(model, opt, mesh, donate=False,
                                   loss_cfg=loss_cfg, finite_guard=True)
        losses, skips = [], []
        for i in range(_STEPS):
            video, text = _batch(i)
            state, loss, skipped = step(state, video, text,
                                        np.zeros((_B,), np.float32))
            losses.append(float(loss))
            skips.append(int(skipped))
        sd = flax_to_torch_state_dict({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})
    return losses, skips, sd, variables


def _torch_run(loss_cfg, variables, poison_step=None,
               dtype=torch.float64):
    model = load_jax_variables(S3D(**_DIMS).to(dtype), variables)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    step = make_train_step(model, optimizer, loss_cfg, finite_guard=True,
                           lr_scheduler=sched)
    losses, skips = [], []
    for i in range(_STEPS):
        hooks = []
        if i == poison_step:
            hooks = [p.register_hook(lambda g: g * float("nan"))
                     for p in model.parameters() if p.requires_grad]
        video, text = _batch(i)
        loss, skipped = step(torch.from_numpy(video),
                             torch.from_numpy(text), torch.zeros(_B))
        for h in hooks:
            h.remove()
        losses.append(float(loss))
        skips.append(skipped)
    return losses, skips, model, optimizer, sched


def _assert_same_state(model, want_sd):
    got = model.state_dict()
    keys = [k for k in want_sd if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in got if not k.endswith(
        "num_batches_tracked")}
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want_sd[key], RTOL,
                                   ATOL, err_msg=key)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_three_steps_match_jax(impl):
    jax_cfg = JaxLossConfig(milnce_impl=impl, milnce_chunk=3,
                            milnce_backend="scan")
    cfg = LossConfig(milnce_impl=impl, milnce_chunk=3, milnce_backend="scan")
    jl, js, jsd, variables = _jax_run(jax_cfg)
    tl, ts, model, _, _ = _torch_run(cfg, variables)
    assert js == ts == [0] * _STEPS
    np.testing.assert_allclose(tl, jl, RTOL, ATOL)
    _assert_same_state(model, jsd)
    # the float32 trainer, as it runs on the card, lands on the same losses
    tl32, _, _, _, _ = _torch_run(cfg, variables, dtype=torch.float32)
    np.testing.assert_allclose(tl32, jl, RTOL, ATOL)
    # the frozen table never moves
    np.testing.assert_array_equal(
        model.text_module.word_embd.weight.numpy(),
        variables["params"]["text_module"]["word_embd"]["embedding"])


def test_finite_guard_skip_matches_jax():
    """Step 2's gradients are poisoned (the JAX fault site on one side, a
    NaN gradient hook on the other): both skip it, keep parameters,
    moments and BatchNorm statistics, and train on from there."""
    cfg = LossConfig(milnce_impl="dense")
    jl, js, jsd, variables = _jax_run(JaxLossConfig(milnce_impl="dense"),
                                      poison="grad.nonfinite@2")
    tl, ts, model, optimizer, sched = _torch_run(cfg, variables,
                                                 poison_step=1)
    assert js == ts == [0, 1, 0]
    np.testing.assert_allclose(tl, jl, RTOL, ATOL)
    _assert_same_state(model, jsd)
    # two applied updates: the schedule and Adam's count advanced twice
    assert sched.last_epoch == 2
    assert all(int(s["step"]) == 2 for s in optimizer.state.values())


def test_first_warmup_step_uses_lr_zero():
    sched = cosine_with_warmup(1e-3, 2, 10)
    assert sched(0) == 0.0 and sched(1) == pytest.approx(5e-4)
    model = S3D(**_DIMS)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" not in k and "num_batches" not in k}
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, lr = build_optimizer(model, opt_cfg,
                                    build_schedule(opt_cfg, 10))
    step = make_train_step(model, optimizer, lr_scheduler=lr)
    step(*(torch.from_numpy(x) for x in _batch(0)), torch.zeros(_B))
    after = model.state_dict()
    for key, val in before.items():
        assert torch.equal(after[key], val), key
    assert optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)


def test_cli_trains_two_steps_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "milnce_tpu_torch.train.cli", "--preset",
         "tiny", "--parallel.platform", "cpu", "--train.max_steps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("Training loss:") == 2
    assert "done: 2 steps" in proc.stdout
