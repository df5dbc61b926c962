"""Port parity, edge-tier quantization: ``milnce_tpu_torch/quant/``
(``quantize``, ``calibrate``, ``distill``) and v2 serving in the port's
engine, against ``milnce_tpu/quant/`` on the CPU.

- Quantization of the weights carried across into the port's model
  (``torch_state_dict_to_flax`` of its state) equals JAX's
  ``quantize_variables`` on the JAX tree bit for bit: int8 arrays and
  scales, per-tensor, per-channel and the readiness rule's choice.
- A port v2 export boots in the JAX engine and a JAX v2 export in the
  port's; embeddings agree within rtol 1e-4 (atol 1e-5).  The port's
  engine keeps the quantized weights as int8 buffers.
- The v1 loader's and the dtype refusals; the verdict parser on the
  committed NUMERICS.md.
- Calibration metadata: the same keys as JAX's, the same activation
  range keys, ``activation_absmax_max`` within rel 1e-4.
- Distillation from the JAX's initial student (handed in through the
  weight bridge): the first 5 losses within rel 1e-4 and the final
  parameters within 1e-5 + 1e-4 max|p|, in float32 on both sides; the
  word table is frozen.
- int8 and student recall@10 against f32 on ``tests/test_quant.py``'s
  tiny corpus, for both packages, within the JAX budgets (0.80, 0.50).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import ModelConfig as JaxModelConfig
from milnce_tpu.models.build import build_model as jax_build_model
from milnce_tpu.quant import calibrate as jax_calibrate
from milnce_tpu.quant import distill as jax_distill
from milnce_tpu.quant import quantize as jax_quant
from milnce_tpu.serving import export as jax_export
from milnce_tpu.serving.engine import InferenceEngine as JaxEngine
from milnce_tpu_torch.config import ModelConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.quant import calibrate, distill, quantize
from milnce_tpu_torch.serving import export
from milnce_tpu_torch.serving.engine import InferenceEngine, load_serving_model
from milnce_tpu_torch.utils.torch_convert import (load_jax_variables,
                                                  torch_state_dict_to_flax)

torch.set_num_threads(1)         # six test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(ROOT, "NUMERICS.md")
_WORDS = 6
_VIDEO = (4, 32, 32, 3)
_CORPUS = 24
_MODEL = dict(embedding_dim=16, vocab_size=128, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
INT8_RECALL_BUDGET = 0.80        # tests/test_quant.py's budgets
STUDENT_RECALL_BUDGET = 0.50
RTOL, ATOL = 1e-4, 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny teacher (tests/test_quant.py's), and the port's model
    holding the same weights."""
    jmodel = jax_build_model(JaxModelConfig(**_MODEL))
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1,) + _VIDEO),
                    jnp.zeros((1, _WORDS), jnp.int32))
    frozen = {"params": _np_tree(v["params"]),
              "batch_stats": _np_tree(v["batch_stats"])}
    model = load_jax_variables(build_model(ModelConfig(**_MODEL)), frozen)
    carried = torch_state_dict_to_flax(
        {k: t.numpy() for k, t in model.state_dict().items()})
    rng = np.random.default_rng(3)
    video = rng.integers(0, 255, (2,) + _VIDEO).astype(np.float32)
    tokens = rng.integers(1, 128, (4, _WORDS)).astype(np.int32)
    return dict(jmodel=jmodel, frozen=frozen, model=model.eval(),
                carried=carried, video=video, tokens=tokens)


def _flat(tree, prefix="params"):
    return dict(quantize._flat_leaves(tree, prefix))


def _assert_same_quant(got, want):
    for tree in ("params", "batch_stats"):
        a, b = _flat(got[tree], tree), _flat(want[tree], tree)
        assert sorted(a) == sorted(b)
        for key in a:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            assert np.array_equal(a[key], b[key]), key
    assert sorted(got["quant_scales"]) == sorted(want["quant_scales"])
    for key, s in want["quant_scales"].items():
        assert got["quant_scales"][key].dtype == np.float32
        assert got["quant_scales"][key].tobytes() == np.asarray(
            s, np.float32).tobytes(), key


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["per_tensor", "per_channel", "readiness"])
def test_quantize_variables_equals_jax_bit_for_bit(tiny, mode):
    keys = {"per_tensor": (),
            "per_channel": tuple(sorted(quantize.quantizable_keys(
                tiny["frozen"]["params"]))),
            "readiness": jax_quant.per_channel_keys_from_weights(
                tiny["frozen"]["params"])}[mode]
    if mode == "readiness":
        assert keys == quantize.per_channel_keys_from_weights(
            tiny["carried"]["params"])
    got = quantize.quantize_variables(tiny["carried"], per_channel_keys=keys)
    want = _np_tree(jax_quant.quantize_variables(tiny["frozen"],
                                                 per_channel_keys=keys))
    want["quant_scales"] = dict(want["quant_scales"])
    _assert_same_quant(got, want)
    with pytest.raises(ValueError, match="not quantizable"):
        quantize.quantize_variables(tiny["carried"],
                                    per_channel_keys=("params/fc/bias",))


@pytest.mark.parametrize("shape", [(7,), (5, 3), (3, 3, 2, 4), (9, 1)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("zero_channel", [False, True])
def test_quantize_array_and_readiness_equal_jax(shape, per_channel,
                                                zero_channel):
    rng = np.random.default_rng(sum(shape))
    arr = rng.standard_normal(shape).astype(np.float32)
    if len(shape) >= 2:
        arr[..., 0] *= 40.0                   # an outlier channel
    if zero_channel:
        arr[..., -1] = 0.0
    assert quantize.weight_readiness_row("k", arr) == \
        jax_quant.weight_readiness_row("k", arr)
    if per_channel and arr.ndim < 2:
        for mod in (quantize, jax_quant):
            with pytest.raises(ValueError, match="ndim >= 2"):
                mod.quantize_array(arr, per_channel=True)
        return
    q, s = quantize.quantize_array(arr, per_channel=per_channel)
    jq, js = jax_quant.quantize_array(arr, per_channel=per_channel)
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
    back = quantize.dequantize_array(torch.from_numpy(q), torch.from_numpy(s))
    assert back.numpy().tobytes() == jax_quant.dequantize_array(
        jq, js).tobytes()


# ---------------------------------------------------------------------------
# v2 artifacts across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(tiny):
    """Both packages' full offline pass on the same weights and batches."""
    port = calibrate.calibrate_and_quantize(
        tiny["model"], tiny["carried"], video_batches=[tiny["video"]],
        text_batches=[tiny["tokens"]])
    ref = jax_calibrate.calibrate_and_quantize(
        tiny["jmodel"], tiny["frozen"], video_batches=[tiny["video"]],
        text_batches=[tiny["tokens"]])
    return dict(port=port, jax=ref)


@pytest.fixture(scope="module")
def exports(tiny, calibrated, tmp_path_factory):
    root = tmp_path_factory.mktemp("quant")
    kw = dict(max_words=_WORDS, video_shape=_VIDEO)
    out = {"port_v2": str(root / "port_v2"), "jax_v2": str(root / "jax_v2"),
           "f32": str(root / "f32")}
    qport, cal = calibrated["port"]
    export.export_quantized_checkpoint(out["port_v2"], qport,
                                       ModelConfig(**_MODEL),
                                       calibration=cal, **kw)
    qjax, jcal = calibrated["jax"]
    jax_export.export_quantized_checkpoint(out["jax_v2"], qjax,
                                           JaxModelConfig(**_MODEL),
                                           calibration=jcal, **kw)
    jax_export.export_inference_checkpoint(
        out["f32"], tiny["frozen"]["params"], tiny["frozen"]["batch_stats"],
        JaxModelConfig(**_MODEL), **kw)
    return out


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _inputs():
    rng = np.random.default_rng(11)
    return (rng.integers(0, 255, (5,) + _VIDEO, dtype=np.uint8),
            rng.integers(1, 128, (7, _WORDS)).astype(np.int32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_v2_export_boots_in_both_engines(exports, writer):
    """Each package's v2 artifact is the same artifact (int8 arrays and
    scales bit for bit), and serves in both engines with the same
    embeddings."""
    path = exports[f"{writer}_v2"]
    _, a = export.load_quantized_checkpoint(exports["port_v2"])
    _, b = export.load_quantized_checkpoint(exports["jax_v2"])
    _assert_same_quant(a, b)
    clips, ids = _inputs()
    port = InferenceEngine.from_export(path, device="cpu", max_batch=8)
    jx = JaxEngine.from_export(path, _mesh(), max_batch=8)
    for got, want in ((port.embed_video(clips), jx.embed_video(clips)),
                      (port.embed_text(ids), jx.embed_text(ids))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert port.recompiles() == 0


def test_int8_stays_resident_and_equals_the_dequantized_f32(exports):
    """The quantized weights live as int8 buffers (no f32 copy of one
    between calls), and the engine equals an f32 engine over the
    host-dequantized weights within 1e-5 + 1e-4 max|e|."""
    model, qvars, _ = load_serving_model(exports["port_v2"])
    engine = InferenceEngine(model, qvars, device="cpu", text_words=_WORDS,
                             video_shape=_VIDEO, max_batch=8)
    qm = engine.model
    n_q = len(qvars["quant_scales"])
    assert len(qm.quantized_names) == n_q > 0
    assert sum(b.dtype == torch.int8 for b in qm.buffers()) == n_q
    params = {n for n, _ in qm.model.named_parameters()}
    assert not params & set(qm.quantized_names)
    # a call dequantizes the weights of the tower it runs, and only those
    text = set(qm.dequantized("text"))
    assert text and all(n.startswith("text_module.") for n in text)
    assert set(qm.dequantized("video")) == set(qm.quantized_names) - text
    assert set(qm.dequantized("all")) == set(qm.quantized_names)
    ref = build_model(ModelConfig(**_MODEL))
    f32 = InferenceEngine(ref, {
        "params": quantize.dequantize_params(qvars["params"],
                                             qvars["quant_scales"]),
        "batch_stats": qvars["batch_stats"]}, device="cpu",
        text_words=_WORDS, video_shape=_VIDEO, max_batch=8)
    assert quantize.resident_bytes(qm) < quantize.resident_bytes(f32.model)
    clips, ids = _inputs()
    for got, want in ((engine.embed_video(clips), f32.embed_video(clips)),
                      (engine.embed_text(ids), f32.embed_text(ids))):
        limit = 1e-5 + 1e-4 * np.abs(want).max()
        assert np.abs(got - want).max() <= limit


def test_v1_loader_and_dtype_refusals(exports):
    with pytest.raises(ValueError, match="load_quantized_checkpoint"):
        export.load_inference_checkpoint(exports["port_v2"])
    for dtype in ("bfloat16", "float32"):
        with pytest.raises(ValueError, match="dtype override"):
            InferenceEngine.from_export(exports["jax_v2"], device="cpu",
                                        dtype=dtype, precompile=False)
    # bfloat16 is served (tests/test_torch_bf16_model.py); a dtype the port
    # has no model for is refused by build_model
    with pytest.raises(ValueError, match="float16"):
        InferenceEngine.from_export(exports["f32"], device="cpu",
                                    dtype="float16", precompile=False)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_verdict_parser_equals_jax_on_the_committed_report(tmp_path):
    got = calibrate.read_numerics_verdicts(REPORT)
    assert got and got == jax_calibrate.read_numerics_verdicts(REPORT)
    report = tmp_path / "NUMERICS.md"
    report.write_text(
        "| layer | shape | absmax | verdict |\n"
        "| --- | --- | --- | --- |\n"
        "| `params/text_module/fc1/kernel` | (8, 16) | 1.2 "
        "| **per-channel** |\n"
        "| `params/conv1/conv/kernel` | (3, 3, 3, 8) | 0.4 "
        "| per-tensor ok |\n")
    assert calibrate.read_numerics_verdicts(str(report)) == {
        "params/text_module/fc1/kernel": True,
        "params/conv1/conv/kernel": False}


def test_committed_verdicts_seed_calibration_as_jax(tiny):
    port, cal = calibrate.calibrate_and_quantize(
        tiny["model"], tiny["carried"], numerics_report=REPORT)
    ref, jcal = jax_calibrate.calibrate_and_quantize(
        tiny["jmodel"], tiny["frozen"], numerics_report=REPORT)
    assert cal == jcal and cal["verdict_source"] == REPORT
    ref = _np_tree(ref)
    ref["quant_scales"] = dict(ref["quant_scales"])
    _assert_same_quant(port, ref)


def test_calibration_metadata_equals_jax(tiny, calibrated):
    _, cal = calibrated["port"]
    _, jcal = calibrated["jax"]
    assert sorted(cal) == sorted(jcal)
    for key in ("scheme", "per_channel", "verdict_source",
                "n_video_batches", "n_text_batches"):
        assert cal[key] == jcal[key], key
    a, b = cal["activation_absmax_max"], jcal["activation_absmax_max"]
    assert abs(a - b) <= 1e-4 * abs(b)
    assert sorted(cal["quality"]) == sorted(jcal["quality"])
    for key, want in jcal["quality"].items():
        if key != "scheme":
            assert abs(cal["quality"][key] - want) <= 1e-4 * abs(want), key
    # every module's range, by the JAX key, not just the top 16
    ranges = calibrate.collect_activation_ranges(
        tiny["model"], video_batches=[tiny["video"]],
        text_batches=[tiny["tokens"]])
    want = jax_calibrate.collect_activation_ranges(
        tiny["jmodel"], tiny["frozen"], video_batches=[tiny["video"]],
        text_batches=[tiny["tokens"]])
    assert sorted(ranges) == sorted(want)
    for key, val in want.items():
        assert abs(ranges[key] - val) <= 1e-4 * max(abs(val), 1e-3), key
    assert set(cal["activation_ranges"]) <= set(want)


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------

_DISTILL = dict(max_words=_WORDS, batch_size=16, seed=0)


@pytest.fixture(scope="module")
def distilled(tiny):
    """The JAX's distillation at 1..5 steps (the same prefix each time:
    its loss at step n is the n-step run's ``final_loss``), and the
    port's 5 steps from the JAX's initial student."""
    from milnce_tpu.models.text import (SentenceEmbedding,
                                        word2vec_embedding_init)

    table = tiny["frozen"]["params"]["text_module"]["word_embd"]["embedding"]
    hidden = max(8, _MODEL["text_hidden_dim"] // 4)
    student = SentenceEmbedding(
        embd_dim=_MODEL["embedding_dim"], vocab_size=_MODEL["vocab_size"],
        word_embedding_dim=_MODEL["word_embedding_dim"], hidden_dim=hidden,
        embedding_init=word2vec_embedding_init(table))
    init = _np_tree(student.init(jax.random.PRNGKey(0),
                                 np.zeros((1, _WORDS), np.int32))["params"])
    runs = [jax_distill.distill_text_student(
        tiny["jmodel"], tiny["frozen"], steps=n, **_DISTILL)
        for n in range(1, 6)]
    params, info = distill.distill_text_student(
        tiny["model"], tiny["carried"], steps=5, init_params=init,
        **_DISTILL)
    return dict(jax=runs, params=params, info=info)


def test_distill_from_the_jax_initial_student_equals_jax(distilled):
    want = [info["final_loss"] for _, info in distilled["jax"]]
    got = distilled["info"]["losses"]
    assert len(got) == 5
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)
    jparams, jinfo = distilled["jax"][-1]
    a, b = _flat(distilled["params"]), _flat(_np_tree(jparams))
    assert sorted(a) == sorted(b)
    for key in b:
        limit = 1e-5 + 1e-4 * np.abs(b[key]).max()
        assert np.abs(a[key] - b[key]).max() <= limit, key
    info = distilled["info"]
    assert {k: info[k] for k in jinfo if k not in ("final_loss",
                                                   "final_cosine")} == {
        k: v for k, v in jinfo.items() if k not in ("final_loss",
                                                    "final_cosine")}
    assert abs(info["final_cosine"] - jinfo["final_cosine"]) <= 1e-4


def test_distilled_student_keeps_the_frozen_word_table(tiny, distilled):
    table = tiny["frozen"]["params"]["text_module"]["word_embd"]["embedding"]
    assert np.array_equal(
        distilled["params"]["word_embd"]["embedding"], table)
    svars = distill.build_student_variables(tiny["carried"],
                                            distilled["params"])
    assert svars["params"]["text_module"] is distilled["params"]
    assert svars["params"]["conv1"] is tiny["carried"]["params"]["conv1"]
    scfg = distill.student_model_config(ModelConfig(**_MODEL), 8)
    assert scfg.text_hidden_dim == 8 and scfg.embedding_dim == 16


# ---------------------------------------------------------------------------
# recall budgets, both packages
# ---------------------------------------------------------------------------

def _recall(idx, base) -> float:
    return float(np.mean([len(set(a) & set(b)) / idx.shape[1]
                          for a, b in zip(idx, base)]))


@pytest.fixture(scope="module")
def recall_exports(tiny, exports, tmp_path_factory):
    """tests/test_quant.py's edge artifacts, made by each package: its
    int8 export (``exports``) and an 80-step student of its own."""
    root = tmp_path_factory.mktemp("students")
    out = {}
    kw = dict(max_words=_WORDS, video_shape=_VIDEO)
    sp, sinfo = distill.distill_text_student(
        tiny["model"], tiny["carried"], max_words=_WORDS, steps=80,
        batch_size=16)
    sv = distill.build_student_variables(tiny["carried"], sp)
    out["port"] = str(root / "port")
    export.export_inference_checkpoint(
        out["port"], sv["params"], sv["batch_stats"],
        distill.student_model_config(ModelConfig(**_MODEL),
                                     sinfo["hidden_dim"]), **kw)
    jp, jinfo = jax_distill.distill_text_student(
        tiny["jmodel"], tiny["frozen"], max_words=_WORDS, steps=80,
        batch_size=16)
    jv = jax_distill.build_student_variables(tiny["frozen"], jp)
    out["jax"] = str(root / "jax")
    jax_export.export_inference_checkpoint(
        out["jax"], jv["params"], jv["batch_stats"],
        jax_distill.student_model_config(JaxModelConfig(**_MODEL),
                                         jinfo["hidden_dim"]), **kw)
    return out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_edge_recall_within_the_jax_budgets(exports, recall_exports,
                                            package):
    rng = np.random.default_rng(11)
    clips = rng.integers(0, 255, (_CORPUS,) + _VIDEO, dtype=np.uint8)
    queries = rng.integers(1, 128, (8, _WORDS)).astype(np.int32)
    dirs = {"f32": exports["f32"], "int8": exports[f"{package}_v2"],
            "student": recall_exports[package]}
    top10 = {}
    for name, path in dirs.items():
        if package == "port":
            engine = InferenceEngine.from_export(path, device="cpu",
                                                 max_batch=16)
        else:
            engine = JaxEngine.from_export(path, _mesh(), max_batch=16)
        corpus = np.concatenate([np.asarray(engine.embed_video(clips[:16])),
                                 np.asarray(engine.embed_video(clips[16:]))])
        text = np.asarray(engine.embed_text(queries))
        top10[name] = np.argsort(-(text @ corpus.T), axis=1)[:, :10]
    assert _recall(top10["int8"], top10["f32"]) >= INT8_RECALL_BUDGET
    assert _recall(top10["student"], top10["f32"]) >= STUDENT_RECALL_BUDGET
