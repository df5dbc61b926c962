"""graftlint Pass 2 of the PyTorch port (``analysis/optrace.py``,
``analysis/trace_invariants.py``): every registered entry's invariants,
the W = 2 and 2-D entries in one spawned pair of gloo ranks for the
module, the guarded step's collectives and its lack of host syncs, the
planted faults each check exists to catch, and the train state's bytes
against ``local_state_bytes`` and the JAX state's leaves."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax

from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu_torch.analysis import trace_invariants as ti
from milnce_tpu_torch.analysis.optrace import state_arguments, trace_call
from milnce_tpu_torch.train import step as step_module
from milnce_tpu_torch.train.state import local_state_bytes

torch.set_num_threads(1)         # six test workers share the cores


def _run(name):
    run = ti.run_entry(name)
    assert not isinstance(run, str), run
    return run


@pytest.mark.parametrize("entry", list(ti.ENTRY_POINTS))
def test_registered_entry_invariants_hold(entry):
    results = ti.run_trace_invariants([entry])
    assert results
    bad = [r.format() for r in results if not r.ok]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("entry", ti.GROUP_ENTRIES)
def test_group_entry_invariants_hold(entry):
    results = ti.run_trace_invariants([entry])
    bad = [r.format() for r in results if not r.ok]
    assert not bad, "\n".join(bad)
    assert {r.check for r in results} >= {"no-f64", "collectives",
                                          "no-host-sync", "kernels"}


def test_every_pin_covers_a_registered_entry():
    traced = set(ti.ALL_ENTRIES) - {"state_dict"}
    assert set(ti.EXPECTED_COLLECTIVES) == traced
    assert set(ti.EXPECTED_LAUNCHES) == traced


@pytest.mark.parametrize("plain,guarded,extra", [
    ("train_step_milnce", "train_step_milnce_guarded", {}),
    ("train_step_milnce@W2", "train_step_milnce_guarded@W2", {}),
    ("train_step_milnce_2d", "train_step_milnce_2d_guarded",
     {"allreduce_": 1}),
], ids=["1-process", "W2", "2d"])
def test_guard_adds_no_collective_but_the_2d_flag(plain, guarded, extra):
    """The finite guard's verdict stays on the device: the guarded step's
    collectives are the plain step's, plus one flag all-reduce over the
    model axis on the 2-D grid (the JAX guarded 2-D step's extra psum)."""
    p, g = _run(plain).collectives, _run(guarded).collectives
    want = dict(p)
    for name, n in extra.items():
        want[name] = want.get(name, 0) + n
    assert g == want


def test_grad_cache_reduces_once_a_step():
    assert _run("grad_cache_step_milnce@W2").grad_reductions == 1
    assert _run("train_step_milnce@W2").grad_reductions == 1
    # the 2-D grid reduce-scatters as often with microbatches as without
    assert (_run("grad_cache_2d").collectives
            == _run("train_step_milnce_2d_guarded").collectives)


@pytest.mark.parametrize("entry", [e for e in ti.ALL_ENTRIES
                                   if e.startswith(("train", "grad_cache"))])
def test_training_entries_make_no_host_sync(entry):
    run = _run(entry)
    assert run.train and run.syncs == []


def test_kernel_path_entries_see_every_launch():
    """On meta the chunked step runs the stream kernels' wrappers, each
    twice a step (rows and columns), and sdtw_3 the soft-DTW kernels."""
    assert _run("train_step_milnce_chunked").launches == {
        "lse_fwd": 2, "lse_bwd_rows": 2, "lse_bwd_cols": 2}
    assert set(_run("train_step_sdtw3").launches) == {"softdtw_fwd",
                                                      "softdtw_bwd"}


def test_reinstated_host_sync_fails_the_check(monkeypatch):
    """The guard as it was (a bool() of the verdict on the host, every
    step) fails no-host-sync."""
    real = step_module._Update._nonfinite

    def synced(self, grads):
        found = real(self, grads)
        if bool(found):
            pass
        return found

    monkeypatch.setattr(step_module._Update, "_nonfinite", synced)
    run = ti.train_entry("guarded-with-sync", ti.tiny_config(), True)
    checks = {c.check: c for c in ti.check_entry(run)}
    assert not checks["no-host-sync"].ok
    assert "_local_scalar_dense" in checks["no-host-sync"].detail


def test_planted_f64_upcast_is_caught(monkeypatch):
    real = step_module._normalize

    def upcast(video_u8, model):
        return real(video_u8, model).double().float()

    monkeypatch.setattr(step_module, "_normalize", upcast)
    run = ti.train_entry("train_step_milnce", ti.tiny_config())
    checks = {c.check: c for c in ti.check_entry(run)}
    assert not checks["no-f64"].ok and "_to_copy" in checks["no-f64"].detail


def test_planted_extra_collective_is_caught(tmp_path):
    """The plain step inside a one-rank gloo group gathers and reduces:
    against the one-process pin that is an extra collective."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        run = ti.train_entry("train_step_milnce", ti.tiny_config(),
                             group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    checks = {c.check: c for c in ti.check_entry(run)}
    assert run.collectives and not checks["collectives"].ok


def test_state_dict_maps_onto_the_jax_tree():
    """The port's keys, through the weight bridge, are the JAX param and
    batch_stats tree's, with num_batches_tracked alone left over."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    tiny = ti.TINY
    jv = JaxS3D(num_classes=tiny["embedding_dim"],
                vocab_size=tiny["vocab_size"],
                word_embedding_dim=tiny["word_embedding_dim"],
                text_hidden_dim=tiny["text_hidden_dim"],
                inception_blocks=tiny["inception_blocks"]).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, ti.FRAMES, ti.SIZE, ti.SIZE, 3), jnp.float32),
        jnp.zeros((2 * ti.K, ti.WORDS), jnp.int32))
    model = build_model(ti.tiny_config().model, seed=0)
    got = torch_state_dict_to_flax({k: v.numpy() for k, v in
                                    model.state_dict().items()})

    def paths(tree):
        return sorted(jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_leaves_with_path(tree))

    for col in ("params", "batch_stats"):
        assert paths(got[col]) == paths(jv[col]), col
    assert _run("state_dict").results[0].ok


def test_state_bytes_equal_local_state_bytes_and_the_jax_state():
    """A tiny step's entry arguments (parameters, buffers, Adam tensors)
    are ``local_state_bytes``; against the JAX state's leaves (params,
    mu, nu, batch_stats) the difference is num_batches_tracked (i64) and
    Adam's step (one f32 a trained tensor)."""
    cfg = ti.tiny_config()
    model, optimizer, step = ti.build_train_step(cfg, True)
    step(*ti.tiny_inputs(0))
    trace, _ = trace_call(step, ti.tiny_inputs(1), model=model,
                          optimizer=optimizer)
    state = sum(s.nbytes for s in trace.all_storages() if s.argument
                and not s.label.startswith(("grad/", "arg")))
    assert state == local_state_bytes(model, optimizer)
    names = [n for n, _ in state_arguments(model, optimizer)]
    tracked = sum(b.numel() * b.element_size() for n, b in
                  model.named_buffers() if n.endswith("num_batches_tracked"))
    steps = sum(st["step"].numel() * st["step"].element_size()
                for st in optimizer.state.values())
    assert tracked and steps and any(n.endswith("/exp_avg") for n in names)

    tiny = ti.TINY
    jv = JaxS3D(num_classes=tiny["embedding_dim"],
                vocab_size=tiny["vocab_size"],
                word_embedding_dim=tiny["word_embedding_dim"],
                text_hidden_dim=tiny["text_hidden_dim"],
                inception_blocks=tiny["inception_blocks"]).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, ti.FRAMES, ti.SIZE, ti.SIZE, 3), jnp.float32),
        jnp.zeros((2 * ti.K, ti.WORDS), jnp.int32))
    opt_cfg = JaxOptimConfig(warmup_steps=2)
    jstate = create_train_state(jv, jax_build_optimizer(
        opt_cfg, jax_build_schedule(opt_cfg, 10)))

    def nbytes(tree):
        return sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(
            tree) if hasattr(x, "dtype"))

    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    jax_bytes = (nbytes(jstate.params) + nbytes(jstate.batch_stats)
                 + nbytes(adam[0].mu) + nbytes(adam[0].nu))
    assert state == jax_bytes + tracked + steps


@pytest.mark.parametrize("plant,rc", [
    (None, 0),
    ("collectives", 1),
    ("peak", 1),
    ("census", 1),
], ids=["clean", "pass2", "pass4", "pass5"])
def test_cli_check_fails_on_a_planted_finding_of_each_trace_pass(
        monkeypatch, capsys, plant, rc):
    """``python -m milnce_tpu_torch.analysis --check`` (in process, over
    one entry) exits 0 on the tree and 1 when a pin of Pass 2, 4 or 5
    disagrees with the trace."""
    from milnce_tpu_torch.analysis import __main__ as cli
    from milnce_tpu_torch.analysis import memplan, numerics

    name = "train_step_milnce_guarded"
    monkeypatch.setattr(ti, "ALL_ENTRIES", (name,))
    if plant == "collectives":
        monkeypatch.setitem(ti.EXPECTED_COLLECTIVES, name, {"allreduce_": 1})
    elif plant == "peak":
        monkeypatch.setitem(memplan.EXPECTED_PEAK_BYTES, name,
                            memplan.EXPECTED_PEAK_BYTES[name] * 2)
    elif plant == "census":
        monkeypatch.setitem(numerics.EXPECTED_DTYPE_CENSUS, name,
                            {"bf16": 1})
    assert cli.main(["--check"]) == rc
    out = capsys.readouterr().out
    assert "0 findings" in out
    if rc:
        want = {"collectives": "collectives", "peak": "GL013",
                "census": "GL018"}[plant]
        assert want in out
