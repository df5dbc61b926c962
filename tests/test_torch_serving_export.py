"""Port parity, serving export (``milnce_tpu_torch/serving/export.py`` and
``engine.load_serving_model``) against ``milnce_tpu/serving/export.py``:
the two packages write and read the same artifact.

- A port export (``milnce-export-torch``'s ``main`` on a port training
  run) boots in the JAX ``load_serving_model`` / ``InferenceEngine``, and
  a JAX export (``milnce-export``'s ``main`` on an Orbax run, as
  ``tests/test_export.py`` makes it) boots in the port's; text and video
  embeddings equal the other package's engine within the model tests'
  ``rtol=1e-4, atol=1e-5``, BatchNorm statistics and the frozen word
  table included.
- Export, load, export again is bit for bit; no optimizer state ships;
  the metadata's keys (and the arrays' Flax paths) equal JAX's, apart
  from ``generator``'s value.
- The format-version gate; the quantized v2 artifact and the live
  index's corpus snapshot round-trip between the packages; the port's
  refusals of a dtype override on v2, of bfloat16 and of a
  ``conv_impl_map``.

The tiny model of ``tests/test_export.py``: embedding 16, vocabulary
128, one Inception block, 4 x 32^2 frames, 6 words.  The JAX engines run
on a 1-device mesh, not warmed, one bucket each.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.serving import export as jax_export
from milnce_tpu.serving.engine import InferenceEngine as JaxEngine
from milnce_tpu.serving.engine import load_serving_model as jax_load_model
from milnce_tpu_torch.config import ModelConfig, OptimConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.serving import export
from milnce_tpu_torch.serving.engine import (InferenceEngine,
                                             load_serving_model)
from milnce_tpu_torch.train.checkpoint import CheckpointManager, train_state
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 1e-4, 1e-5
_FRAMES, _SIZE, _WORDS, _VOCAB, _DIM = 4, 32, 6, 128, 16
_MODEL = dict(embedding_dim=_DIM, vocab_size=_VOCAB, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
_CLI_MODEL_FLAGS = ["--model.embedding_dim", str(_DIM),
                    "--model.vocab_size", str(_VOCAB),
                    "--model.word_embedding_dim", "8",
                    "--model.text_hidden_dim", "16",
                    "--model.inception_blocks", "1",
                    "--data.max_words", str(_WORDS)]


def _arrays(export_dir):
    with np.load(os.path.join(export_dir, export.ARRAYS_FILE)) as z:
        return {k: z[k] for k in z.files}


def _meta(export_dir):
    with open(os.path.join(export_dir, export.METADATA_FILE)) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port training run: the tiny model, BatchNorm statistics and
    update counters drawn from a seed (so the bridge carries real
    statistics), one Adam step taken (so the checkpoint holds moments)."""
    model = build_model(ModelConfig(**_MODEL), seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
            elif name.endswith("num_batches_tracked"):
                buf.fill_(7)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, lr = build_optimizer(model, opt_cfg,
                                    build_schedule(opt_cfg, 10))
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    optimizer.step()
    lr.step()
    root = str(tmp_path_factory.mktemp("port-run"))
    CheckpointManager(root).save(0, train_state(model, optimizer, lr,
                                                step=3, epoch=0))
    return dict(dir=root, model=model, optimizer=optimizer)


@pytest.fixture(scope="module")
def port_export(port_run, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port-export"))
    export.main(["--checkpoint_dir", port_run["dir"], "--out", out,
                 "--preset", "tiny"] + _CLI_MODEL_FLAGS)
    return out


@pytest.fixture(scope="module")
def jax_export_dir(tmp_path_factory):
    """``milnce-export`` of a JAX Orbax run of the same tiny model."""
    from milnce_tpu.config import ModelConfig as JaxModelConfig
    from milnce_tpu.config import OptimConfig as JaxOptimConfig
    from milnce_tpu.models.build import build_model as jax_build_model
    from milnce_tpu.train.checkpoint import CheckpointManager as JaxManager
    from milnce_tpu.train.schedule import build_schedule as jax_schedule
    from milnce_tpu.train.state import build_optimizer as jax_optimizer
    from milnce_tpu.train.state import create_train_state

    model = jax_build_model(JaxModelConfig(**_MODEL))
    variables = dict(model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, _FRAMES, _SIZE, _SIZE, 3)),
                                jnp.zeros((1, _WORDS), jnp.int32)))
    rng = np.random.default_rng(5)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.random(x.shape, np.float32) + 0.5),
        variables["batch_stats"])
    opt_cfg = JaxOptimConfig(warmup_steps=2)
    state = create_train_state(variables, jax_optimizer(
        opt_cfg, jax_schedule(opt_cfg, 10)))
    ckpt = str(tmp_path_factory.mktemp("jax-run"))
    mgr = JaxManager(ckpt, keep=2)
    mgr.save(0, state)
    mgr.wait()
    mgr.close()
    out = str(tmp_path_factory.mktemp("jax-export"))
    jax_export.main(["--checkpoint_dir", ckpt, "--out", out,
                     "--preset", "tiny"] + _CLI_MODEL_FLAGS)
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(6)
    ids = rng.integers(1, _VOCAB, (3, _WORDS)).astype(np.int32)
    ids[0, 4:] = 0                                   # a padded caption
    clips = rng.integers(0, 256, (2, _FRAMES, _SIZE, _SIZE, 3),
                         dtype=np.uint8)
    return ids, clips


def _jax_engine(export_dir):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return JaxEngine.from_export(export_dir, mesh, max_batch=4,
                                 precompile=False)


def _embed_both(export_dir, inputs):
    ids, clips = inputs
    port = InferenceEngine.from_export(export_dir, device="cpu", max_batch=4,
                                       precompile=False)
    jx = _jax_engine(export_dir)
    return ((port.embed_text(ids), np.asarray(jx.embed_text(ids))),
            (port.embed_video(clips), np.asarray(jx.embed_video(clips))))


@pytest.mark.parametrize("which", ["port-export", "jax-export"])
def test_export_boots_in_both_engines_with_equal_embeddings(
        which, port_export, jax_export_dir, inputs):
    export_dir = port_export if which == "port-export" else jax_export_dir
    for entry, (port, jx) in zip(("text", "video"),
                                 _embed_both(export_dir, inputs)):
        assert port.shape == jx.shape == (len(port), _DIM), entry
        assert port.dtype == np.float32
        np.testing.assert_allclose(port, jx, RTOL, ATOL, err_msg=entry)


def test_port_export_equals_the_checkpoint_bit_for_bit(port_run,
                                                       port_export):
    """The artifact's arrays are the checkpoint's model state under Flax
    paths, bit for bit; nothing else ships (no optimizer state, no
    BatchNorm update counters)."""
    _, state = CheckpointManager(port_run["dir"], create=False).restore_raw()
    got = _arrays(port_export)
    tree = torch_state_dict_to_flax({k: v.numpy() for k, v in state.items()})
    flat = export._flatten(tree["params"], "params")
    flat.update(export._flatten(tree["batch_stats"], "batch_stats"))
    assert sorted(got) == sorted(flat)
    for key, value in flat.items():
        assert got[key].dtype == np.float32
        assert np.array_equal(got[key], value), key
    assert all(k.startswith(("params/", "batch_stats/")) for k in got)
    assert not any("opt" in k or "exp_avg" in k or "num_batches" in k
                   for k in got)
    meta = _meta(port_export)
    assert meta["step"] == 3 and meta["format_version"] == 1
    n_opt = sum(t.numel() for s in port_run["optimizer"].state.values()
                for t in s.values() if torch.is_tensor(t) and t.dim())
    assert n_opt > 0 and meta["param_bytes"] == sum(
        v.nbytes for v in got.values())


def test_export_load_export_is_bit_for_bit(port_export, tmp_path):
    meta, variables = export.load_inference_checkpoint(port_export)
    again = export.export_inference_checkpoint(
        str(tmp_path / "again"), variables["params"],
        variables["batch_stats"], ModelConfig(**meta["model"]),
        max_words=meta["tokenizer"]["max_words"],
        video_shape=meta["video_shape"], step=meta["step"],
        source=meta["source_checkpoint"])
    first, second = _arrays(port_export), _arrays(again)
    assert sorted(first) == sorted(second)
    for key in first:
        assert first[key].dtype == second[key].dtype
        assert first[key].tobytes() == second[key].tobytes(), key
    assert _meta(again) == _meta(port_export)


def test_metadata_keys_equal_jax(port_export, jax_export_dir):
    port, jx = _meta(port_export), _meta(jax_export_dir)
    assert sorted(port) == sorted(jx)
    for section in ("model", "tokenizer"):
        assert sorted(port[section]) == sorted(jx[section])
    assert port["model"] == jx["model"]
    assert port["tokenizer"] == jx["tokenizer"]
    assert port["video_shape"] == jx["video_shape"] == [_FRAMES, _SIZE,
                                                        _SIZE, 3]
    # the same Flax paths, dtypes and sizes: one artifact layout
    assert port["array_dtypes"] == jx["array_dtypes"]
    assert port["param_bytes"] == jx["param_bytes"]
    assert port["generator"] != jx["generator"]
    assert "milnce_tpu_torch/serving/export.py" in port["generator"]
    # a port artifact's model config builds the JAX model config
    from milnce_tpu.config import ModelConfig as JaxModelConfig

    JaxModelConfig(**export.load_inference_checkpoint(port_export)[0]["model"])


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_format_version_gate(loader, port_export, tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(port_export, bad)
    meta = _meta(bad)
    meta["format_version"] = 999
    (bad / export.METADATA_FILE).write_text(json.dumps(meta))
    load = (export.load_inference_checkpoint if loader == "port"
            else jax_export.load_inference_checkpoint)
    with pytest.raises(ValueError, match="format"):
        load(str(bad))


def _qvariables(export_dir):
    """The tiny model's variables with two kernels quantized to int8 (one
    per-channel scale vector, one scalar scale)."""
    _, variables = export.load_inference_checkpoint(export_dir)
    params = variables["params"]
    scales = {}
    text = params["text_module"]
    for name, axis in (("fc1", 0), ("fc2", None)):
        w = text[name]["kernel"]
        amax = (np.abs(w).max(axis=axis) if axis is not None
                else np.abs(w).max())
        scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
        text[name]["kernel"] = np.clip(np.round(w / scale), -127,
                                       127).astype(np.int8)
        scales[f"params/text_module/{name}/kernel"] = scale
    return {"params": params, "batch_stats": variables["batch_stats"],
            "quant_scales": scales}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_quantized_v2_round_trips_between_packages(writer, port_export,
                                                   tmp_path):
    from milnce_tpu.config import ModelConfig as JaxModelConfig

    meta = _meta(port_export)
    q = _qvariables(port_export)
    kw = dict(max_words=_WORDS, video_shape=meta["video_shape"], step=3,
              calibration={"batches": 2})
    out = str(tmp_path / "v2")
    if writer == "port":
        export.export_quantized_checkpoint(
            out, q, ModelConfig(**_MODEL), **kw)
        qmeta, back = jax_export.load_quantized_checkpoint(out)
    else:
        jax_export.export_quantized_checkpoint(
            out, q, JaxModelConfig(**_MODEL), **kw)
        qmeta, back = export.load_quantized_checkpoint(out)
    assert qmeta["format_version"] == 2
    assert qmeta["quant"]["n_quantized"] == 2
    assert qmeta["quant"]["per_channel"] == [
        "params/text_module/fc1/kernel"]
    for tree in ("params", "batch_stats"):
        want = export._flatten(q[tree], tree)
        got = export._flatten(back[tree], tree)
        assert sorted(want) == sorted(got)
        for key in want:
            assert got[key].dtype == (np.int8 if want[key].dtype == np.int8
                                      else np.float32), key
            assert np.array_equal(got[key], want[key]), key
    assert sorted(back["quant_scales"]) == sorted(q["quant_scales"])
    for key, scale in q["quant_scales"].items():
        assert np.array_equal(back["quant_scales"][key], scale)
    # the v1 loaders of both packages refuse it, naming the v2 loader
    for load in (export.load_inference_checkpoint,
                 jax_export.load_inference_checkpoint):
        with pytest.raises(ValueError, match="quantized"):
            load(out)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_corpus_snapshot_round_trips_between_packages(writer, tmp_path):
    emb = np.random.default_rng(7).standard_normal((9, _DIM)).astype(
        np.float32)
    out = str(tmp_path / "snap")
    write, read = ((export.export_corpus_snapshot,
                    jax_export.load_corpus_snapshot) if writer == "port"
                   else (jax_export.export_corpus_snapshot,
                         export.load_corpus_snapshot))
    write(out, emb, generation=4, k=3, source="test")
    meta, back = read(out)
    assert back.tobytes() == emb.tobytes()
    assert {k: meta[k] for k in ("format_version", "generation", "k",
                                 "size", "dim", "source")} == {
        "format_version": 1, "generation": 4, "k": 3, "size": 9,
        "dim": _DIM, "source": "test"}
    assert sorted(os.listdir(out)) == [export.INDEX_ARRAYS_FILE,
                                       export.INDEX_METADATA_FILE]


def test_port_refuses_v2_and_bfloat16(port_export, tmp_path):
    """Since the port has ``quant/`` it serves a v2 artifact (int8
    resident); what stays refused is a dtype override on one, as in JAX,
    and a bfloat16 model."""
    out = str(tmp_path / "v2")
    export.export_quantized_checkpoint(
        out, _qvariables(port_export), ModelConfig(**_MODEL),
        max_words=_WORDS, video_shape=_meta(port_export)["video_shape"])
    for dtype in ("float32", "bfloat16"):
        with pytest.raises(ValueError, match="quant"):
            load_serving_model(out, dtype=dtype)
        with pytest.raises(ValueError, match="quant"):
            InferenceEngine.from_export(out, device="cpu", dtype=dtype,
                                        precompile=False)
    engine = InferenceEngine.from_export(out, device="cpu", max_batch=2)
    assert {b.dtype for b in engine.model.buffers()} >= {torch.int8}
    with pytest.raises(ValueError, match="bfloat16"):
        load_serving_model(port_export, dtype="bfloat16")
    with pytest.raises(ValueError, match="bfloat16"):
        InferenceEngine.from_export(port_export, device="cpu",
                                    dtype="bfloat16", precompile=False)


def test_port_refuses_a_conv_impl_map(jax_export_dir, tmp_path):
    """A JAX export whose model carries a ``conv_impl_map`` (a TPU conv
    lowering) is refused by the port's ``build_model`` with its message,
    before any weight is loaded; the JAX loader takes it."""
    bad = tmp_path / "impl-map"
    shutil.copytree(jax_export_dir, bad)
    meta = _meta(bad)
    meta["model"]["conv_impl_map"] = "conv1=im2col"
    (bad / export.METADATA_FILE).write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="conv_impl_map is not ported"):
        load_serving_model(str(bad))
    jax_load_model(str(bad))
