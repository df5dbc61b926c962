"""Port parity, ``parallel.overlap_grad_reduce`` on the 2-D steps
(``parallel/sharding_map.py``, ``parallel/dist.py::IssueQueue``,
``train/step.py``) over ``torch.distributed`` (gloo, CPU), against the JAX
2-D steps built with ``overlap_grad_reduce=True`` / ``False``.

The model, weights and batches are ``tests/test_train_2d.py``'s (16 clips,
sync BatchNorm over every rank, FSDP threshold 256); the port runs in
float64 on ranks from ``tests/torch_dist_worker.py``, JAX in f32 here:

- on the (2 x 2) and (4 x 2) grids, three steps of the port's 2-D step
  under each setting equal JAX's 2-D step under the same setting, for
  MIL-NCE, sdtw_3 and the grad-cache step at M = 2 (losses rtol 2e-4,
  atol 2e-5, ``tests/test_train_2d.py``'s tolerance);
- the port's two settings equal each other in float64 within 1e-12
  relative: losses, parameters, BatchNorm statistics, Adam's moments;
- the issue queue issues in its fixed order whatever order the leaves
  become final in, and every rank's step issues the leaves in the map's
  order reversed, during the backward;
- the grad-cache step at M = 2 issues no reduction before its last
  microbatch's backward, and its reductions are the plain 2-D step's.
"""

import collections
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_train_2d as jax2d
import torch_dist_worker as worker
from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.config import ParallelConfig as JaxParallelConfig
from milnce_tpu.parallel.mesh import build_mesh as jax_build_mesh
from milnce_tpu.parallel.sharding_map import (place_tree,
                                              state_partition_specs)
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import make_grad_cache_step as jax_grad_cache_step
from milnce_tpu.train.step import make_train_step as jax_train_step
from milnce_tpu_torch.parallel.dist import IssueQueue

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 2e-4, 2e-5          # tests/test_train_2d.py
SAME = 1e-12                     # the two settings, float64
STEPS = 3                        # step 3's loss reads step 2's update
DIMS = dict(num_classes=16, vocab_size=jax2d._VOCAB, word_embedding_dim=8,
            text_hidden_dim=16, inception_blocks=1)
# label -> (loss, micro_batches)
CASES = {"milnce": ("milnce", 1), "sdtw_3": ("sdtw_3", 1),
         "gc": ("milnce", 2)}
JAX_LOSS = {"milnce": None,
            "sdtw_3": JaxLossConfig(name="sdtw_3", sdtw_backend="scan")}
GRIDS = {4: "2x2", 8: "4x2"}


def _variables():
    variables = jax2d._model(None).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, jax2d._FRAMES, jax2d._SIZE, jax2d._SIZE, 3),
                  jnp.float32),
        jnp.zeros((2, jax2d._WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _cases():
    return {f"{label}-{overlap}": dict(loss=loss, model_size=2,
                                       micro_batches=m, overlap=overlap,
                                       census=label != "sdtw_3")
            for label, (loss, m) in CASES.items()
            for overlap in (True, False)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> per-rank ``{label: result}``, one spawn for each grid."""
    variables = _variables()
    batches = [jax2d._batch(i) for i in range(STEPS)]
    return {w: worker.spawn(worker.layout_runs, w,
                            tmp_path_factory.mktemp(f"overlap-w{w}"), DIMS,
                            variables, batches, _cases())
            for w in GRIDS}


def _jax_losses(n_dev, label, overlap):
    """JAX's 2-D step on the (n_dev / 2 x 2) mesh, ``overlap_grad_reduce``
    as given: ``tests/test_train_2d.py::_train`` on the first ``n_dev``
    devices."""
    loss, m = CASES[label]
    mesh = jax_build_mesh(JaxParallelConfig(model_axis="model",
                                            model_parallel_size=2),
                          devices=jax.devices()[:n_dev])
    model = jax2d._model(("data", "model"))
    variables = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, jax2d._FRAMES, jax2d._SIZE, jax2d._SIZE, 3),
                  jnp.float32),
        jnp.zeros((2, jax2d._WORDS), jnp.int32))
    cfg = JaxOptimConfig(warmup_steps=2)
    opt = jax_build_optimizer(cfg, jax_build_schedule(cfg, 10))
    state = create_train_state(variables, opt)
    specs = state_partition_specs(state, mesh, "model",
                                  min_size=jax2d._MIN_SIZE)
    state = place_tree(state, specs, mesh)
    kw = dict(donate=False, loss_cfg=JAX_LOSS.get(loss), state_specs=specs,
              model_axis="model", overlap_grad_reduce=overlap)
    step = (jax_grad_cache_step(model, opt, mesh, m, **kw) if m > 1
            else jax_train_step(model, opt, mesh, **kw))
    losses = []
    for i in range(STEPS):
        state, value = step(state, *jax2d._batch(i))
        losses.append(float(value))
    return losses


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "fused"])
@pytest.mark.parametrize("label", list(CASES))
@pytest.mark.parametrize("world", list(GRIDS), ids=list(GRIDS.values()))
def test_2d_step_matches_jax_under_each_setting(ranks, world, label,
                                                overlap):
    got = ranks[world]
    run = got[0][f"{label}-{overlap}"]
    for r in got:
        assert r[f"{label}-{overlap}"]["losses"] == run["losses"]
        assert r[f"{label}-{overlap}"]["skips"] == [0] * STEPS
        assert r[f"{label}-{overlap}"]["state_digest"] == run["state_digest"]
    np.testing.assert_allclose(run["losses"],
                               _jax_losses(world, label, overlap),
                               RTOL, ATOL, err_msg=f"{label} vs JAX")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (scale if scale else 1.0)


@pytest.mark.parametrize("label", list(CASES))
@pytest.mark.parametrize("world", list(GRIDS), ids=list(GRIDS.values()))
def test_the_two_settings_agree_in_float64(ranks, world, label):
    per_leaf, fused = (ranks[world][0][f"{label}-{o}"] for o in (True, False))
    assert _rel(per_leaf["losses"], fused["losses"]) <= SAME
    for key, val in fused["state"].items():
        assert _rel(per_leaf["state"][key], val) <= SAME, key
    for name, (m, v) in fused["moments"].items():
        assert _rel(per_leaf["moments"][name][0], m) <= SAME, name
        assert _rel(per_leaf["moments"][name][1], v) <= SAME, name


@pytest.mark.parametrize("seed", range(4))
def test_issue_queue_issues_in_its_fixed_order(seed):
    """Leaves made final in a shuffled order go out in the queue's order:
    a ready prefix as it grows, the rest at the flush, a leaf with no
    input skipped."""
    n = 12
    absent = {3, 8}
    issued, trail = [], []
    queue = IssueQueue(n, issued.append)
    order = [i for i in range(n) if i not in absent]
    random.Random(seed).shuffle(order)
    for i in order[:-2]:
        queue.ready(i)
        trail.append(list(issued))
        assert issued == list(range(len(issued)))
    queue.flush(lambda i: i not in absent)
    assert issued == [i for i in range(n) if i not in absent]
    # issued only once the prefix up to it was final
    done = set()
    for i, seen in zip(order[:-2], trail):
        done.add(i)
        assert all(j in done or j in absent for j in seen)
    queue.reset()
    issued.clear()
    queue.flush(lambda i: True)
    assert issued == list(range(n))


def _reductions(census):
    return collections.Counter(e for e in census if e[1:] == ("reduction",))


def _map_order():
    from milnce_tpu_torch.models.s3dg import S3D

    model = S3D(**DIMS)
    return [n for n, p in reversed(list(model.named_parameters()))
            if p.requires_grad]


@pytest.mark.parametrize("world", list(GRIDS), ids=list(GRIDS.values()))
def test_every_rank_issues_the_leaves_in_the_reversed_map_order(ranks,
                                                                 world):
    order = _map_order()
    for r in ranks[world]:
        census = r["milnce-True"]["census"]
        issued = [e[1] for e in census if e[0] == "issue"]
        assert issued == order
        # every leaf goes out inside the backward, while the backward's
        # own collectives (sync BatchNorm's) still run
        end = census.index(("backward_end",))
        first = census.index(("issue", order[0]))
        assert all(e[0] != "issue" for e in census[end:])
        assert ("all_reduce", "other") in census[first:end]
        # fused: the collectives after the backward, in the map's order
        fused = r["milnce-False"]["census"]
        end = fused.index(("backward_end",))
        assert not any(e[0] == "issue" for e in fused)
        assert not _reductions(fused[:end])


@pytest.mark.parametrize("world", list(GRIDS), ids=list(GRIDS.values()))
def test_grad_cache_reduces_after_its_last_microbatch_alone(ranks, world):
    """At M = 2 pass 2 runs two backwards; no reduction starts before the
    second, and the step's reductions are the plain 2-D step's, under
    both settings (JAX: "identical communication")."""
    for r in ranks[world]:
        for overlap in (True, False):
            census = r[f"gc-{overlap}"]["census"]
            starts = [i for i, e in enumerate(census) if e == ("backward",)]
            assert len(starts) == 2
            assert not _reductions(census[:starts[-1]])
            assert _reductions(census) == _reductions(
                r[f"milnce-{overlap}"]["census"])
        per_leaf = r["gc-True"]["census"]
        assert [e[1] for e in per_leaf if e[0] == "issue"] == _map_order()
