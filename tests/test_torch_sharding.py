"""Port parity, the FSDP sharding map (``milnce_tpu_torch/parallel/
sharding_map.py``) against ``milnce_tpu/parallel/sharding_map.py``.

The port decides the map in the JAX paths and dimensions and translates
each decision to the torch layout (``utils/torch_convert.py``'s bridge):

- for the tiny preset's model at model sizes 2 and 4 (at the default
  threshold and at 256), the port's map read back in JAX paths and
  dimensions equals JAX ``build_param_specs`` leaf for leaf, and its
  ``describe_map`` summary and ``map_hash`` are JAX's;
- the torch dimension it shards is the Flax dimension moved through the
  converter's transposition;
- the threshold is inclusive; overrides (inline and JSON) and their
  errors behave as JAX's; equal layouts hash equal.
"""

import json

import pytest
import torch

import jax
import jax.numpy as jnp

from milnce_tpu.config import ParallelConfig as JaxParallelConfig
from milnce_tpu.models.build import build_model as jax_build_model
from milnce_tpu.parallel.mesh import build_mesh as jax_build_mesh
from milnce_tpu.parallel import sharding_map as jax_smap
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.parallel import sharding_map as smap

torch.set_num_threads(1)         # six test workers share the cores


@pytest.fixture(scope="module")
def models():
    cfg = tiny_preset()
    jax_model = jax_build_model(cfg.model)
    params = jax_model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.data.num_frames, cfg.data.video_size,
                   cfg.data.video_size, 3), jnp.float32),
        jnp.zeros((1, cfg.data.max_words), jnp.int32))["params"]
    return build_model(cfg.model, seed=0), params


def _jax_map(params, model_size, min_size, spec=""):
    mesh = jax_build_mesh(JaxParallelConfig(model_axis="model",
                                            model_parallel_size=model_size))
    specs = jax_smap.build_param_specs(params, mesh, "model",
                                       min_size=min_size, spec=spec)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    dims = {jax_smap._path_str(path): jax_smap.sharded_dim(sp, "model")
            for (path, _), sp in zip(flat, jax_smap.spec_leaves(specs))}
    return dims, jax_smap.describe_map(params, specs, "model"), specs


@pytest.mark.parametrize("min_size", [smap.DEFAULT_FSDP_MIN_SIZE, 256])
@pytest.mark.parametrize("model_size", [2, 4])
def test_map_equals_jax_leaf_for_leaf(models, model_size, min_size):
    model, params = models
    entries = smap.build_param_map(model, model_size, min_size)
    want, summary, specs = _jax_map(params, model_size, min_size)
    assert {e.path: e.flax_dim for e in entries} == want
    assert smap.describe_map(entries, "model") == summary
    assert smap.map_hash(smap.describe_map(entries, "model")) == \
        jax_smap.map_hash(summary)
    assert smap.sharded_count(entries) == jax_smap.sharded_count(specs,
                                                                 "model") > 0


def test_torch_dim_is_the_flax_dim_through_the_converter(models):
    """Conv (O, I, t, h, w) <-> (t, h, w, I, O); linear (O, I) <-> (I, O);
    the embedding keeps its rows."""
    model, _ = models
    shapes = dict(model.named_parameters())
    perms = {5: (2, 3, 4, 1, 0), 2: (1, 0)}
    seen = set()
    for e in smap.build_param_map(model, 2, 256):
        if e.flax_dim is None:
            continue
        shape = tuple(shapes[e.name].shape)
        perm = ((0, 1) if e.name.endswith("word_embd.weight")
                else perms.get(len(shape), (0,)))
        assert e.torch_dim == perm[e.flax_dim], e.name
        assert shape[e.torch_dim] == e.flax_shape[e.flax_dim]
        seen.add(len(shape))
    assert seen >= {5, 2}


def test_threshold_is_inclusive():
    """``>= min_size`` elements shards (JAX ``_auto_dim``); one fewer
    replicates; ties break to the last dimension."""
    assert smap._auto_dim((3, 3, 3, 8, 16), 2, 3456) == 4
    assert smap._auto_dim((3, 3, 3, 8, 16), 2, 3457) is None
    assert smap._auto_dim((16, 16), 2, 1) == 1
    assert smap._auto_dim((7, 9), 2, 1) is None
    for shape, size, min_size in [((3, 3, 3, 8, 16), 2, 3456),
                                  ((3, 3, 3, 8, 16), 2, 3457),
                                  ((16, 16), 4, 1), ((64, 32), 2, 2048),
                                  ((7, 9), 2, 1), ((4, 2, 4), 4, 32)]:
        assert smap._auto_dim(shape, size, min_size) == \
            jax_smap._auto_dim(shape, size, min_size), (shape, size)


def test_overrides_parse_as_jax(tmp_path):
    inline = "conv/*=4,dense/*=-"
    assert smap.parse_sharding_spec(inline) == \
        jax_smap.parse_sharding_spec(inline) == {"conv/*": 4, "dense/*": None}
    path = tmp_path / "map.json"
    path.write_text(json.dumps({"sharding_map": {"conv/*": 0, "d/*": "-"}}))
    assert smap.parse_sharding_spec(str(path)) == \
        jax_smap.parse_sharding_spec(str(path))
    assert smap.parse_sharding_spec("") == {}
    for bad, match in [("conv/kernel,dense=1", "missing '='"),
                       ("conv/*=big", "integer dim")]:
        with pytest.raises(ValueError, match=match):
            smap.parse_sharding_spec(bad)
        with pytest.raises(ValueError, match=match):
            jax_smap.parse_sharding_spec(bad)


@pytest.mark.parametrize("spec,match", [
    ("nothing/here=0", "matched no parameter"),
    ("conv1/conv/kernel=9", "out of range"),
    ("conv1/conv/kernel=0", "does not divide")],
    ids=["unmatched", "out-of-range", "indivisible"])
def test_override_errors_as_jax(models, spec, match):
    model, params = models
    with pytest.raises(ValueError, match=match):
        smap.build_param_map(model, 2, 256, spec)
    with pytest.raises(ValueError, match=match):
        _jax_map(params, 2, 256, spec)


def test_overrides_move_the_layout_as_in_jax(models):
    """A force-replicate and a forced dimension land on the same leaves
    in both packages, and the layout's hash moves with them."""
    model, params = models
    spec = "conv1/conv/kernel=-,text_module/fc1/kernel=0"
    entries = smap.build_param_map(model, 2, 256, spec)
    want, summary, _ = _jax_map(params, 2, 256, spec)
    got = {e.path: e.flax_dim for e in entries}
    assert got == want
    assert got["conv1/conv/kernel"] is None
    assert got["text_module/fc1/kernel"] == 0
    base = smap.describe_map(smap.build_param_map(model, 2, 256), "model")
    assert smap.map_hash(smap.describe_map(entries, "model")) != \
        smap.map_hash(base)


def test_equal_layouts_hash_equal(models):
    """The hash reads the layout, not how it was asked for: the automatic
    rule and an override that restates its choice hash alike."""
    model, _ = models
    auto = smap.build_param_map(model, 2, 256)
    first = next(e for e in auto if e.flax_dim is not None)
    restated = smap.build_param_map(model, 2, 256,
                                    f"{first.path}={first.flax_dim}")
    a = smap.describe_map(auto, "model")
    assert smap.map_hash(a) == smap.map_hash(smap.describe_map(restated,
                                                               "model"))
    assert smap.map_hash(dict(reversed(list(a.items())))) == smap.map_hash(a)
    assert len(smap.map_hash(a)) == 12
