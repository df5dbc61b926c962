"""Port parity, the bf16 model: ``S3D(dtype=torch.bfloat16)`` against the
JAX package's ``S3D(dtype=jnp.bfloat16)`` from the same f32 weights (the
port's seeded init, carried to Flax by ``torch_state_dict_to_flax``), on
the same uint8 clips and token ids made from a numpy seed.

Covered: the train-mode forward of both towers (the clip normalized into
bf16 as the train step does), the parameter gradients of a fixed linear
read-out of both embeddings and the BatchNorm running statistics it
folds; the eval-mode embed functions of both towers.  Tolerances
(``tests/torch_bf16_close.py``), the reference being the same port model
moved to float64: the embeddings within 8 bf16 unit roundoffs of their
largest magnitude of JAX's (ten bf16 layers, each rounding at every op),
the running statistics within 4 (f32 sums of bf16 activations), each no
farther from the reference in norm than 2x JAX's; the parameter
gradients as a group between 1/2x and 2x JAX's distance from the
reference (each tensor within 4x), since at this tiny batch the bf16
gradients through BatchNorm carry 10-30 % noise in both frameworks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.train.step import make_text_embed_fn as jax_text_fn
from milnce_tpu.train.step import make_video_embed_fn as jax_video_fn
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.train.step import (_normalize, make_text_embed_fn,
                                         make_video_embed_fn)
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables,
                                                  torch_state_dict_to_flax)

from torch_bf16_close import assert_bf16_close, assert_bf16_group

torch.set_num_threads(1)         # six test workers share the cores

_DIMS = dict(num_classes=16, vocab_size=32, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_B, _K, _FRAMES, _SIZE, _WORDS = 4, 2, 4, 32, 5
EMB_ULPS, STAT_ULPS = 8, 4


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    weights = S3D(**_DIMS)
    variables = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in weights.state_dict().items()})
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (_B, _FRAMES, _SIZE, _SIZE, 3),
                         dtype=np.uint8)
    text = rng.integers(0, _DIMS["vocab_size"], (_B * _K, _WORDS)
                        ).astype(np.int32)
    w_v = rng.standard_normal((_B, _DIMS["num_classes"])).astype(np.float32)
    w_t = rng.standard_normal((_B * _K, _DIMS["num_classes"])
                              ).astype(np.float32)
    return variables, video, text, w_v, w_t


def _port(variables, dtype):
    """The port's model from ``variables``: bf16 compute over f32 weights,
    or the f32 model moved to float64 (the reference)."""
    if dtype == torch.bfloat16:
        return load_jax_variables(S3D(dtype=dtype, **_DIMS), variables)
    return load_jax_variables(S3D(**_DIMS).to(dtype), variables)


def _jax_train(variables, video, text, w_v, w_t):
    model = JaxS3D(dtype=jnp.bfloat16, **_DIMS)

    def loss(params, video, text):
        x = video.astype(jnp.bfloat16) / jnp.asarray(255, jnp.bfloat16)
        (v, t), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, text, train=True, mutable=["batch_stats"])
        value = (jnp.sum(v.astype(jnp.float32) * w_v)
                 + jnp.sum(t.astype(jnp.float32) * w_t))
        return value, (v, t, mutated["batch_stats"])

    (_, (v, t, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"], video, text)
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": grads, "batch_stats": stats}))
    return v, t, sd


def _port_train(variables, video, text, w_v, w_t, dtype):
    model = _port(variables, dtype).train()
    v, t = model(_normalize(torch.from_numpy(video), model),
                 torch.from_numpy(text))
    value = (v.to(w_v.dtype) * w_v).sum() + (t.to(w_t.dtype) * w_t).sum()
    value.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: b for n, b in model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return v, t, grads, stats


def test_train_forward_gradients_and_statistics_match_jax(setup):
    variables, video, text, w_v, w_t = setup
    jv, jt, jsd = _jax_train(variables, video, text, w_v, w_t)
    outs = {}
    for dtype, wdt in ((torch.bfloat16, torch.float32),
                       (torch.float64, torch.float64)):
        outs[dtype] = _port_train(variables, video, text,
                                  torch.tensor(w_v, dtype=wdt),
                                  torch.tensor(w_t, dtype=wdt), dtype)
    (tv, tt, tg, ts), (rv, rt, rg, rs) = (outs[torch.bfloat16],
                                          outs[torch.float64])
    assert tv.dtype == tt.dtype == torch.bfloat16
    assert {g.dtype for g in tg.values()} == {torch.float32}
    assert {s.dtype for s in ts.values()} == {torch.float32}
    assert_bf16_close(tv, jv, rv, EMB_ULPS, "video embedding")
    assert_bf16_close(tt, jt, rt, EMB_ULPS, "text embedding")
    assert_bf16_group(tg, jsd, rg, "parameter gradients")
    assert set(ts) == set(rs) and ts
    for name, s in ts.items():
        assert_bf16_close(s, jsd[name], rs[name], STAT_ULPS, name)


def test_embed_functions_match_jax(setup):
    variables, video, text, _, _ = setup
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    model = JaxS3D(dtype=jnp.bfloat16, **_DIMS)
    jv = jax_video_fn(model, mesh)(variables, video)
    jt = jax_text_fn(model, mesh)(variables, text)
    assert jv.dtype == jt.dtype == jnp.bfloat16
    got, ref = {}, {}
    for dtype, out in ((torch.bfloat16, got), (torch.float64, ref)):
        m = _port(variables, dtype)
        out["video"] = make_video_embed_fn(m)(torch.from_numpy(video))
        out["text"] = make_text_embed_fn(m)(torch.from_numpy(text))
    assert got["video"].dtype == got["text"].dtype == torch.bfloat16
    assert_bf16_close(got["video"], jv, ref["video"], EMB_ULPS, "video")
    assert_bf16_close(got["text"], jt, ref["text"], EMB_ULPS, "text")
