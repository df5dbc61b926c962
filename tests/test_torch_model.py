"""Port parity, model: the torch S3D-G against ``milnce_tpu.models.S3D``
with the JAX package's weights carried across by ``load_jax_variables``.

Inputs are made from a seed with numpy and fed to both.  Tolerance f32
``rtol=1e-4, atol=1e-5``: the convolutions sum in another order in the
two frameworks.  Covered: eval mode, train-mode BatchNorm (outputs and
the updated running statistics; Flax folds the *biased* batch variance,
torch's stock layer the unbiased one), gating on and off, the
space-to-depth stem on and off, the mixed_5c features, the TF-SAME
asymmetric max pool at odd sizes, the space-to-depth channel order, the
embedding functions, and the state-dict round trip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.models.s3dg import _tf_same_max_pool as jax_pool
from milnce_tpu.models.s3dg import space_to_depth as jax_s2d
from milnce_tpu.utils.torch_convert import torch_state_dict_to_flax
from milnce_tpu_torch.config import ModelConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.models.s3dg import S3D, _tf_same_max_pool, space_to_depth
from milnce_tpu_torch.train.step import make_text_embed_fn, make_video_embed_fn
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 1e-4, 1e-5
_DIMS = dict(num_classes=16, vocab_size=128, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=2)


def _inputs(seed=0, b=2, frames=4, size=32, k=2, words=5):
    rng = np.random.RandomState(seed)
    video = rng.rand(b, frames, size, size, 3).astype(np.float32)
    text = rng.randint(0, 128, (b * k, words)).astype(np.int32)
    return video, text


def _pair(gating, s2d, seed=0):
    jm = JaxS3D(gating=gating, use_space_to_depth=s2d, **_DIMS)
    video, text = _inputs(seed)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(video),
                        jnp.asarray(text))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = load_jax_variables(S3D(gating=gating, use_space_to_depth=s2d,
                                **_DIMS), variables)
    return jm, tm, variables, video, text


_CONFIGS = [(True, False), (False, False), (True, True)]
_IDS = ["gating", "no-gating", "gating-s2d"]


@pytest.mark.parametrize("gating,s2d", _CONFIGS, ids=_IDS)
def test_eval_embeddings_match(gating, s2d):
    jm, tm, variables, video, text = _pair(gating, s2d)
    jv, jt = jax.jit(lambda v, a, b: jm.apply(v, a, b))(variables, video,
                                                        text)
    tm.eval()
    with torch.no_grad():
        tv, tt = tm(torch.from_numpy(video), torch.from_numpy(text))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), RTOL, ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), RTOL, ATOL)


@pytest.mark.parametrize("gating,s2d", _CONFIGS, ids=_IDS)
def test_mixed5c_features_match(gating, s2d):
    jm, tm, variables, video, _ = _pair(gating, s2d, seed=1)
    feats = jax.jit(lambda v, a: jm.apply(v, a, None, mode="video",
                                          mixed5c=True))(variables, video)
    tm.eval()
    with torch.no_grad():
        tf = tm(torch.from_numpy(video), None, mode="video", mixed5c=True)
    assert tf.shape == feats.shape
    np.testing.assert_allclose(tf.numpy(), np.asarray(feats), RTOL, ATOL)


@pytest.mark.parametrize("gating,s2d", _CONFIGS, ids=_IDS)
def test_train_mode_batchnorm_outputs_and_biased_running_var(gating, s2d):
    jm, tm, variables, video, text = _pair(gating, s2d, seed=2)
    (jv, jt), mutated = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, train=True, mutable=["batch_stats"]))(variables, video, text)
    tm.train()
    tv, tt = tm(torch.from_numpy(video), torch.from_numpy(text))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), RTOL,
                               ATOL)
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt), RTOL,
                               ATOL)
    want = flax_to_torch_state_dict({
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              mutated["batch_stats"])})
    got = tm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(got[key].numpy(), want[key], RTOL, ATOL,
                                   err_msg=key)


def test_running_var_uses_the_biased_batch_variance():
    from milnce_tpu_torch.models.s3dg import BatchNorm3d

    bn = BatchNorm3d(3)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 2, 3, 3)
                         .astype(np.float32))
    bn.train()
    bn(x)
    biased = x.var(dim=(0, 2, 3, 4), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape,window,strides", [
    ((1, 5, 7, 9, 2), (1, 3, 3), (1, 2, 2)),
    ((2, 5, 7, 9, 3), (3, 3, 3), (2, 2, 2)),
    ((1, 3, 5, 5, 2), (2, 2, 2), (2, 2, 2)),
], ids=["stem", "pool4a", "pool5a"])
def test_tf_same_max_pool_odd_sizes(shape, window, strides):
    # values of both signs: the pool pads with -inf, never with 0
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), window, strides))
    got = _tf_same_max_pool(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                            window, strides).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_space_to_depth_channel_order():
    x = np.arange(2 * 4 * 6 * 8 * 3, dtype=np.float32).reshape(2, 4, 6, 8, 3)
    want = np.asarray(jax_s2d(jnp.asarray(x)))
    got = space_to_depth(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


def test_embed_fns_match_jax_apply():
    jm, tm, variables, video, text = _pair(True, False, seed=5)
    video_u8 = (video * 255).astype(np.uint8)
    want_v = jm.apply(variables, jnp.asarray(video_u8, jnp.float32) / 255.0,
                      None, mode="video")
    want_t = jm.apply(variables, None, jnp.asarray(text), mode="text")
    got_v = make_video_embed_fn(tm)(torch.from_numpy(video_u8))
    got_t = make_text_embed_fn(tm)(torch.from_numpy(text))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), RTOL, ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), RTOL, ATOL)


def test_state_dict_round_trip_and_frozen_table():
    _, tm, variables, _, _ = _pair(True, True, seed=6)
    back = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
    assert not tm.text_module.word_embd.weight.requires_grad


@pytest.mark.parametrize("scheme", ["uniform", "kaiming_normal"])
def test_build_model_is_seeded_and_full_width(scheme):
    cfg = ModelConfig(vocab_size=128, weight_init=scheme)
    a, b = build_model(cfg, seed=3), build_model(cfg, seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert a.fc.in_features == 1024 and a.fc.out_features == 512
    assert tuple(a.text_module.fc1.weight.shape) == (2048, 300)
