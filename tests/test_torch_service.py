"""Port parity, HTTP service: ``milnce_tpu_torch/serving/service.py`` and
``milnce-serve-torch`` against ``milnce_tpu/serving/service.py`` on the
CPU.

- ``parse_tier_spec`` equals JAX's (values, order and refusal messages)
  over a set of specs.
- ``AdmissionController`` decisions (admitted, or the shed reason and
  its retry hint) equal JAX's for the same call sequence of admits,
  flush observations and queue depths, with and without tiers.  The
  controller reads no clock; the "clock" is the scripted sequence of
  flush durations it is fed.
- One tiny export and corpus served by both packages' services over
  HTTP: every reply's code, body keys, ``Retry-After`` header and error
  kind/reason equal JAX's (200, 400, 404, 429 overload and tier
  overload, ``/healthz``'s sections and keys); the rankings are equal
  and the scores within rtol 1e-4 (the towers in f32 on each side).
- The Prometheus exposition of the port's service carries every metric
  name JAX's does.
- The serving capture (``obs.capture.OwnedCapture``) starts and stops
  its profiler on one owner thread whichever thread arms it, refuses a
  second arm while one is held, and arms from the anomaly path without
  waiting.
- ``milnce-serve-torch`` refuses to start on a host without a card
  unless ``--parallel.platform cpu``; on the CPU it boots a live index,
  ingests over HTTP and, after SIGTERM, reboots from its snapshot with
  the same ranking bit for bit and the generation kept.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from milnce_tpu.config import ModelConfig as JaxModelConfig
from milnce_tpu.models.build import build_model as jax_build_model
from milnce_tpu.obs import metrics as jax_metrics
from milnce_tpu.serving import service as jax_service
from milnce_tpu.serving.engine import InferenceEngine as JaxEngine
from milnce_tpu.serving.export import export_inference_checkpoint
from milnce_tpu.serving.index import DeviceRetrievalIndex as JaxIndex
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.serving import service
from milnce_tpu_torch.serving.cache import EmbeddingLRUCache
from milnce_tpu_torch.serving.engine import InferenceEngine
from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

torch.set_num_threads(1)         # six test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORDS = 6
_VIDEO = (4, 32, 32, 3)
_MODEL = dict(embedding_dim=16, vocab_size=64, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
_CORPUS, _K = 20, 5


# ---------------------------------------------------------------------------
# tiers and admission, call for call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "interactive:1.0", "interactive:1.0,batch:0.5",
    " a:0.25 , b:1 ,", "a:0.5,a:0.5", "a", ":0.5", "a:0", "a:1.5",
    "a:-1", "a:x"])
def test_parse_tier_spec_equals_jax(spec):
    try:
        want = jax_service.parse_tier_spec(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            service.parse_tier_spec(spec)
        assert str(got.value) == str(exc)
        return
    got = service.parse_tier_spec(spec)
    assert got == want and list(got) == list(want)


def _script(mod, tiers, max_inflight):
    """Run one scripted sequence through ``mod``'s AdmissionController:
    nested admits (held open), flush observations, depth changes ->
    the list of outcomes."""
    depth = [0]
    ac = mod.AdmissionController(
        max_inflight, max_batch=4, lanes=2, depth_fn=lambda: depth[0],
        registry=(obs_metrics.MetricsRegistry() if mod is service
                  else jax_metrics.MetricsRegistry()), tiers=tiers)
    out, held = [], []
    steps = [("admit", 2, None, None), ("admit", 1, 50.0, "batch"),
             ("depth", 40), ("admit", 1, 100.0, None),
             ("flush", 30.0), ("flush", 10.0), ("admit", 1, 100.0, None),
             ("admit", 1, 1000.0, None), ("admit", 3, None, "batch"),
             ("admit", 6, None, None), ("release",), ("depth", 0),
             ("admit", 2, 5.0, "batch"), ("admit", 1, None, "nope"),
             ("release",), ("release",), ("admit", 4, None, None)]
    for step in steps:
        if step[0] == "depth":
            depth[0] = step[1]
        elif step[0] == "flush":
            ac.observe_flush(step[1], 4)
        elif step[0] == "release":
            if held:
                held.pop().__exit__(None, None, None)
        else:
            _, rows, timeout, tier = step
            cm = ac.admit(rows, timeout, tier)
            try:
                cm.__enter__()
                held.append(cm)
                out.append(("admitted", ac.inflight))
            except mod.ShedError as exc:
                out.append(("shed", exc.reason, exc.retry_after_ms))
            except ValueError as exc:
                out.append(("error", str(exc)))
    stats = ac.stats()
    while held:
        held.pop().__exit__(None, None, None)
    return out, stats, ac.inflight


@pytest.mark.parametrize("tiers", ["", "interactive:1.0,batch:0.5"])
@pytest.mark.parametrize("max_inflight", [0, 6, 10])
def test_admission_decisions_equal_jax(tiers, max_inflight):
    got = _script(service, tiers, max_inflight)
    want = _script(jax_service, tiers, max_inflight)
    assert got == want


# ---------------------------------------------------------------------------
# the two services over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """One export (random JAX weights) served by both packages: engine,
    frozen index over the same corpus, service, HTTP front."""
    import jax.numpy as jnp

    root = tmp_path_factory.mktemp("svc")
    jmodel = jax_build_model(JaxModelConfig(**_MODEL))
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1,) + _VIDEO),
                    jnp.zeros((1, _WORDS), jnp.int32))
    export_dir = str(root / "export")
    export_inference_checkpoint(
        export_dir, jax.tree_util.tree_map(np.asarray, dict(v["params"])),
        jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"])),
        JaxModelConfig(**_MODEL), max_words=_WORDS, video_shape=_VIDEO)
    corpus = np.random.default_rng(3).standard_normal(
        (_CORPUS, 16)).astype(np.float32)
    np.savez(str(root / "corpus.npz"), emb=corpus)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    kw = dict(max_delay_ms=2.0, max_inflight=4,
              tiers="interactive:1.0,batch:0.5")
    jeng = JaxEngine.from_export(export_dir, mesh, max_batch=8)
    jsvc = jax_service.RetrievalService(
        jeng, JaxIndex(mesh, corpus, k=_K, query_buckets=jeng.buckets),
        cache=EmbeddingLRUCache(64), registry=jax_metrics.MetricsRegistry(),
        **kw)
    peng = InferenceEngine.from_export(export_dir, device="cpu", max_batch=8)
    psvc = service.RetrievalService(
        peng, DeviceRetrievalIndex(corpus, k=_K, query_buckets=peng.buckets,
                                   device="cpu"),
        cache=EmbeddingLRUCache(64), registry=obs_metrics.MetricsRegistry(),
        **kw)
    servers = {}
    import threading

    for name, (mod, svc) in {"jax": (jax_service, jsvc),
                             "port": (service, psvc)}.items():
        srv = mod.serve_http(svc, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers[name] = (f"http://127.0.0.1:{srv.server_address[1]}", srv,
                         svc)
    yield dict(servers=servers, export_dir=export_dir, root=root,
               corpus=corpus)
    for _, srv, svc in servers.values():
        srv.shutdown()
        svc.close()


def _call(base, route, payload=None):
    if payload is None:
        req = urllib.request.Request(base + route)
    else:
        req = urllib.request.Request(
            base + route, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            code, headers = r.status, r.headers
    except urllib.error.HTTPError as e:
        body, code, headers = e.read(), e.code, e.headers
    try:
        payload = json.loads(body)
    except ValueError:
        payload = body.decode()
    return code, payload, headers.get("Retry-After")


def _shape(x):
    """A reply's structure: dict keys (recursively), list lengths of
    lists of lists, the kind/reason strings of refusals."""
    if isinstance(x, dict):
        return {k: (x[k] if k in ("kind", "reason") else _shape(x[k]))
                for k in x}
    if isinstance(x, list):
        return [len(x)] + ([_shape(x[0])] if x and isinstance(
            x[0], (dict, list)) else [])
    return type(x).__name__


_IDS = np.random.default_rng(9).integers(1, 64, (3, _WORDS)).tolist()

_REQUESTS = [
    ("/v1/query", {"token_ids": _IDS, "k": 3}),
    ("/v1/query", {"token_ids": _IDS[:1], "tier": "batch"}),
    ("/v1/embed_text", {"token_ids": _IDS[:2]}),
    ("/v1/query", {"token_ids": _IDS[:1], "tier": "nope"}),
    ("/v1/query", {"token_ids": _IDS[:1], "k": 99}),
    ("/v1/query", {"sentences": ["a clip"]}),
    ("/v1/query", {}),
    ("/v1/query", {"token_ids": _IDS + _IDS}),               # 6 rows > 4
    ("/v1/query", {"token_ids": _IDS, "tier": "batch"}),     # 3 > cap 2
    ("/v1/index/add", {"embeddings": [[0.0] * 16]}),
    ("/obs/capture", {"reason": "x"}),
    ("/v1/nothing", {}),
]


@pytest.mark.parametrize("n", range(len(_REQUESTS)))
def test_http_replies_have_the_jax_contract(stacks, n):
    route, payload = _REQUESTS[n]
    replies = {name: _call(base, route, payload)
               for name, (base, _, _) in stacks["servers"].items()}
    (jc, jb, jr), (pc, pb, pr) = replies["jax"], replies["port"]
    assert pc == jc, (pc, pb, jb)
    assert pr == jr
    assert _shape(pb) == _shape(jb)
    if pc in (429, 503, 504):
        assert pr is not None and int(pr) >= 1


def test_rankings_equal_the_jax_service(stacks):
    (_, jb, _), (_, pb, _) = (_call(stacks["servers"][n][0], "/v1/query",
                                    {"token_ids": _IDS})
                              for n in ("jax", "port"))
    for jr, pr in zip(jb["results"], pb["results"]):
        assert pr["indices"] == jr["indices"]
        np.testing.assert_allclose(pr["scores"], jr["scores"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("route", ["/healthz", "/obs/events?n=5",
                                   "/obs/events?n=x", "/obs/events?since=y",
                                   "/nothing"])
def test_get_routes_have_the_jax_contract(stacks, route):
    _call(stacks["servers"]["jax"][0], "/v1/query", {"token_ids": _IDS})
    _call(stacks["servers"]["port"][0], "/v1/query", {"token_ids": _IDS})
    (jc, jb, _), (pc, pb, _) = (_call(stacks["servers"][n][0], route)
                                for n in ("jax", "port"))
    assert pc == jc
    if route == "/healthz":
        assert sorted(pb) == sorted(jb)
        for section in ("batcher", "cache", "index", "admission"):
            assert sorted(pb[section]) == sorted(jb[section]), section
        assert set(jb["engine"]) <= set(pb["engine"])
        assert pb["engine"]["recompiles"] == 0
    elif pc == 200:
        assert sorted(pb) == sorted(jb) == ["events"]


def _metric_names(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")}


def test_prometheus_exposition_carries_the_jax_metric_names(stacks):
    _, jtext, _ = _call(stacks["servers"]["jax"][0], "/metrics")
    _, ptext, _ = _call(stacks["servers"]["port"][0], "/metrics")
    want = _metric_names(jtext)
    assert want and want <= _metric_names(ptext), \
        want - _metric_names(ptext)


# ---------------------------------------------------------------------------
# the serving capture's owner thread
# ---------------------------------------------------------------------------

def test_owned_capture_starts_and_stops_on_one_owner_thread(tmp_path):
    import threading

    from milnce_tpu_torch.obs.capture import OwnedCapture, ProfilerCapture
    from milnce_tpu_torch.obs.spans import SpanRecorder

    seen = []
    cap = ProfilerCapture(
        str(tmp_path), duration_s=0.3, cooldown_s=0.0, max_captures=2,
        recorder=SpanRecorder(),
        start_fn=lambda d: seen.append(("start", threading.get_ident())),
        stop_fn=lambda: seen.append(("stop", threading.get_ident())))
    owned = OwnedCapture(cap)
    try:
        got = []
        t = threading.Thread(target=lambda: got.append(owned.arm("http")))
        t.start()
        t.join(10)
        assert got[0]["armed"] and got[0]["capture"] == 1
        assert owned.arm("again") == {"armed": False,
                                      "reason": "capture active"}
        deadline = time.monotonic() + 10
        while len(seen) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        owned.arm_async(reason="flush_spike")       # returns at once
        deadline = time.monotonic() + 10
        while len(seen) < 4 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert owned.arm("spent")["reason"].startswith("budget exhausted")
    finally:
        owned.close()
    assert [k for k, _ in seen] == ["start", "stop", "start", "stop"]
    owners = {tid for _, tid in seen}
    assert len(owners) == 1 and threading.get_ident() not in owners
    assert owners != {t.ident}


# ---------------------------------------------------------------------------
# milnce-serve-torch
# ---------------------------------------------------------------------------

def _serve(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "milnce_tpu_torch.serving.service",
         "--preset", "tiny"] + args, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        OMP_NUM_THREADS="1")


def test_cli_refuses_without_a_card_unless_cpu(stacks):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal needs none")
    proc = _serve(["--serve.export_dir", stacks["export_dir"]], _env())
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in out and "listening" not in out


def _boot(args, env):
    proc = _serve(args, env)
    line = proc.stdout.readline()
    while line and "listening on" not in line:
        line = proc.stdout.readline()
    assert "listening on" in line, line
    return proc, line.split("http://")[1].split(" ")[0]


def test_cli_on_the_cpu_serves_a_live_index_and_reboots_from_its_snapshot(
        stacks):
    snap = str(stacks["root"] / "snap")
    args = ["--parallel.platform", "cpu", "--serve.export_dir",
            stacks["export_dir"], "--serve.corpus_npz",
            str(stacks["root"] / "corpus.npz"), "--serve.port", "0",
            "--serve.max_batch", "8", "--serve.topk", str(_K),
            "--serve.live_index", "true", "--serve.index_snapshot_dir", snap,
            "--serve.continuous_batching", "true",
            "--serve.tiers", "interactive:1.0,batch:0.5",
            "--serve.max_inflight", "16"]
    env = _env()
    proc, host = _boot(args, env)
    base = f"http://{host}"
    try:
        code, body, _ = _call(base, "/v1/index/add", {
            "embeddings": np.ones((3, 16)).tolist(), "wait": True})
        assert code == 200 and body["live"] and body["generation"] == 1
        code, first, _ = _call(base, "/v1/query", {"token_ids": _IDS})
        assert code == 200 and first["index_generation"] == 1
        code, health, _ = _call(base, "/healthz")
        assert health["index"]["size"] == _CORPUS + 3
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    assert proc.returncode == 0
    assert os.path.exists(os.path.join(snap, "index_meta.json"))
    proc, host = _boot(args, env)
    try:
        code, again, _ = _call(f"http://{host}", "/v1/query",
                               {"token_ids": _IDS})
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    assert code == 200 and again == first
