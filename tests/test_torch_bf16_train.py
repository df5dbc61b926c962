"""Port parity, bf16 training: the port's train steps with a bf16 model
(``S3D(dtype=torch.bfloat16)``, f32 parameters, Adam and BatchNorm
statistics) against the JAX package's with ``S3D(dtype=jnp.bfloat16)``,
from the same f32 weights and the same batches made from a numpy seed.

Cases, two optimizer steps each (the first at the warmup's lr 0, so the
second moves the parameters): MIL-NCE ``chunked`` (the JAX stream on its
Pallas kernel's bf16 mode in interpret mode, the port's on its plain
twin), the grad-cache step at M = 2 (the same loss), and ``sdtw_3`` (the
soft-DTW costs cast to f32 before the recurrence on both sides: the JAX
Pallas kernel, the port's plain recurrence under ``auto``).  Compared:
the losses, every parameter, Adam's ``exp_avg`` and ``exp_avg_sq`` and
the BatchNorm running statistics.  Tolerances (``tests/torch_bf16_close.
py``), the reference being the same port steps on the f32 weights moved
to float64: the losses and the running statistics within 4 bf16 unit
roundoffs of their largest magnitude of JAX's and no farther from the
reference in norm than 2x JAX's; the parameters, ``exp_avg`` and
``exp_avg_sq``, each as a group, between 1/2x and 2x JAX's distance from
the reference (each tensor within 4x): their bf16 noise (gradients
through BatchNorm at a tiny batch, turned into lr-sized steps by Adam)
is 10-30 % of a gradient in both frameworks.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import make_grad_cache_step as jax_grad_cache_step
from milnce_tpu.train.step import make_train_step as jax_train_step
from milnce_tpu_torch.config import LossConfig, OptimConfig
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_grad_cache_step, make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables,
                                                  torch_state_dict_to_flax)

from torch_bf16_close import assert_bf16_close, assert_bf16_group

torch.set_num_threads(1)         # six test workers share the cores

_DIMS = dict(num_classes=16, vocab_size=32, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_B, _K, _FRAMES, _SIZE, _WORDS, _STEPS = 4, 2, 4, 32, 5, 2
ULPS = 4
# name: (loss config kwargs of each package, microbatches)
_CASES = {
    "milnce-chunked": (dict(name="milnce", milnce_impl="chunked",
                            milnce_chunk=3, milnce_backend="pallas"),
                       dict(name="milnce", milnce_impl="chunked",
                            milnce_chunk=3, milnce_backend="auto"), 1),
    "grad-cache-m2": (dict(name="milnce", milnce_impl="chunked",
                           milnce_chunk=3, milnce_backend="pallas"),
                      dict(name="milnce", milnce_impl="chunked",
                           milnce_chunk=3, milnce_backend="auto"), 2),
    "sdtw_3": (dict(name="sdtw_3", sdtw_backend="auto"),
               dict(name="sdtw_3", sdtw_backend="auto"), 1)}


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(1)
    variables = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in S3D(**_DIMS).state_dict().items()})
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 256, (_B, _FRAMES, _SIZE, _SIZE, 3),
                             dtype=np.uint8),
                rng.integers(0, _DIMS["vocab_size"], (_B * _K, _WORDS)
                             ).astype(np.int32),
                np.arange(_B, dtype=np.float32) * 7.0)
               for _ in range(_STEPS)]
    return variables, batches


def _jax_moments(opt_state) -> dict:
    """Adam's (exp_avg, exp_avg_sq) of the masked JAX optimizer, by torch
    name."""
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


def _jax_run(variables, batches, loss_kw, micro):
    model = JaxS3D(dtype=jnp.bfloat16, **_DIMS)
    opt_cfg = JaxOptimConfig(warmup_steps=2)
    opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
    state = create_train_state(variables, opt)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    kw = dict(donate=False, loss_cfg=JaxLossConfig(**loss_kw),
              finite_guard=True)
    step = (jax_grad_cache_step(model, opt, mesh, micro, **kw) if micro > 1
            else jax_train_step(model, opt, mesh, **kw))
    losses = []
    for video, text, start in batches:
        state, loss, skipped = step(state, video, text, start)
        assert int(skipped) == 0
        losses.append(float(loss))
    sd = flax_to_torch_state_dict({
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              state.batch_stats)})
    return np.array(losses), sd, _jax_moments(state.opt_state)


def _port_run(variables, batches, loss_kw, micro, dtype):
    """The port's steps on a bf16 model, or (float64) on the f32 model
    moved to float64: the reference."""
    if dtype == torch.bfloat16:
        model = load_jax_variables(S3D(dtype=dtype, **_DIMS), variables)
    else:
        model = load_jax_variables(S3D(**_DIMS).to(dtype), variables)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    kw = dict(finite_guard=True, lr_scheduler=sched)
    cfg = LossConfig(**loss_kw)
    step = (make_grad_cache_step(model, optimizer, micro, cfg, **kw)
            if micro > 1 else make_train_step(model, optimizer, cfg, **kw))
    losses = []
    for video, text, start in batches:
        loss, skipped = step(torch.from_numpy(video), torch.from_numpy(text),
                             torch.from_numpy(start).to(dtype))
        assert int(skipped) == 0
        losses.append(float(loss))
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    moments = {n: (optimizer.state[p]["exp_avg"],
                   optimizer.state[p]["exp_avg_sq"])
               for n, p in model.named_parameters() if p in optimizer.state}
    return np.array(losses), state, moments


@pytest.mark.parametrize("case", list(_CASES))
def test_two_bf16_steps_match_jax(setup, case):
    variables, batches = setup
    jax_kw, port_kw, micro = _CASES[case]
    jl, jsd, jmom = _jax_run(variables, batches, jax_kw, micro)
    tl, tsd, tmom = _port_run(variables, batches, port_kw, micro,
                              torch.bfloat16)
    rl, rsd, rmom = _port_run(variables, batches, port_kw, micro,
                              torch.float64)
    assert {v.dtype for v in tsd.values()} == {torch.float32}
    assert_bf16_close(tl, jl, rl, ULPS, "losses")
    stats = {k for k in tsd if k.endswith(("running_mean", "running_var"))}
    assert stats
    for name in stats:
        assert_bf16_close(tsd[name], jsd[name], rsd[name], ULPS, name)
    params = set(tsd) - stats
    assert_bf16_group({k: tsd[k] for k in params}, jsd,
                      {k: rsd[k] for k in params}, "parameters")
    assert set(tmom) == set(rmom) == set(jmom)
    for i, moment in enumerate(("exp_avg", "exp_avg_sq")):
        assert_bf16_group({k: m[i] for k, m in tmom.items()},
                          {k: m[i] for k, m in jmom.items()},
                          {k: m[i] for k, m in rmom.items()}, moment)
