"""Port parity, the asset converter (``milnce_tpu_torch/utils/assets.py``,
``milnce-assets-torch``) against ``milnce_tpu/utils/assets.py``.

A reference ``.pth`` (the DDP flavor, the tiny model's weights with
drawn BatchNorm statistics) goes to a port run directory and back to a
``.pth`` with equal tensors, through the functions and through the CLI;
the run directory resumes in the port's trainer state; the float
tensors equal the JAX converter's round trip (Orbax run directory and
back), whose BatchNorm counters it zeroes.  ``word2vec`` and
``inspect`` as the JAX CLI's.
"""

import numpy as np
import pytest
import torch

from milnce_tpu_torch.config import ModelConfig, OptimConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.train.checkpoint import CheckpointManager, load_train_state
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.utils import assets

torch.set_num_threads(1)         # six test workers share the cores

_MODEL = dict(embedding_dim=16, vocab_size=128, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
_FLAGS = ["--preset", "tiny", "--model.embedding_dim", "16",
          "--model.word_embedding_dim", "8", "--model.text_hidden_dim", "16",
          "--model.inception_blocks", "1"]


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    model = build_model(ModelConfig(**_MODEL), seed=11)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
            elif name.endswith("num_batches_tracked"):
                buf.fill_(5)
    path = tmp_path_factory.mktemp("ref") / "epoch0003.pth.tar"
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v.clone()
                                           for k, v in
                                           model.state_dict().items()}},
               path)
    return str(path), model.state_dict()


def _state_dict(path):
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return raw["epoch"], {k.removeprefix("module."): v
                          for k, v in raw["state_dict"].items()}


@pytest.mark.parametrize("route", ["functions", "cli"])
def test_pth_to_run_dir_and_back_is_equal(route, reference_pth, tmp_path):
    src, want = reference_pth
    run, back = str(tmp_path / "run"), str(tmp_path / "back.pth")
    if route == "functions":
        assert assets.convert_checkpoint(src, run, ModelConfig(**_MODEL)) == 3
        assert assets.export_checkpoint(run, back) == 3
    else:
        assets.main(["ckpt", src, run] + _FLAGS)
        assets.main(["export", run, back])
    epoch, got = _state_dict(back)
    assert epoch == 3 and sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def test_run_dir_resumes_in_the_port(reference_pth, tmp_path):
    """The converted directory holds what the trainer's resume reads (a
    fresh Adam state, its schedule, step 0) and loads strictly."""
    src, want = reference_pth
    run = str(tmp_path / "run")
    assets.convert_checkpoint(src, run, ModelConfig(**_MODEL))
    mgr = CheckpointManager(run, create=False)
    assert mgr.all_epochs() == [3]
    state = mgr.restore(3)
    assert sorted(state) == ["epoch", "model", "optimizer", "scheduler",
                             "step"]
    assert state["step"] == 0 and state["epoch"] == 3
    model = build_model(ModelConfig(**_MODEL), seed=0)
    opt_cfg = OptimConfig()
    optimizer, lr = build_optimizer(model, opt_cfg, build_schedule(opt_cfg, 4))
    assert load_train_state(state, model, optimizer, lr) == 0
    for key, value in want.items():
        assert torch.equal(model.state_dict()[key], value), key


def test_round_trip_floats_equal_the_jax_converters(reference_pth, tmp_path):
    from milnce_tpu.utils import assets as jax_assets

    src, want = reference_pth
    jax_back = str(tmp_path / "jax.pth")
    jax_assets.convert_checkpoint(src, str(tmp_path / "orbax"))
    jax_assets.export_checkpoint(str(tmp_path / "orbax"), jax_back)
    port_back = str(tmp_path / "port.pth")
    assets.convert_checkpoint(src, str(tmp_path / "run"),
                              ModelConfig(**_MODEL))
    assets.export_checkpoint(str(tmp_path / "run"), port_back)
    (jax_epoch, jax_sd), (port_epoch, port_sd) = (_state_dict(jax_back),
                                                  _state_dict(port_back))
    assert jax_epoch == port_epoch == 3 and sorted(jax_sd) == sorted(port_sd)
    for key, value in port_sd.items():
        if key.endswith("num_batches_tracked"):
            assert int(jax_sd[key]) == 0 and int(value) == 5
            continue
        assert torch.equal(jax_sd[key].to(value.dtype), value), key


@pytest.mark.parametrize("flavor", ["tensor", "embedding"])
def test_word2vec_equals_jax(flavor, tmp_path):
    from milnce_tpu.utils import assets as jax_assets

    table = torch.randn((11, 5), generator=torch.Generator().manual_seed(1))
    obj = table if flavor == "tensor" else torch.nn.Embedding.from_pretrained(
        table)
    src = str(tmp_path / "word2vec.pth")
    torch.save(obj, src)
    assert tuple(assets.convert_word2vec(src, str(tmp_path / "port.npy"))) \
        == (11, 5)
    jax_assets.convert_word2vec(src, str(tmp_path / "jax.npy"))
    port, jx = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert port.dtype == np.float32 and np.array_equal(port, jx)
    assert np.array_equal(port, table.numpy())


def test_inspect_prints_as_jax(reference_pth, capsys):
    from milnce_tpu.utils import assets as jax_assets

    src, _ = reference_pth
    assets.main(["inspect", src])
    port = capsys.readouterr().out
    jax_assets.inspect(src)
    assert port == capsys.readouterr().out
    assert port.splitlines()[0].endswith("(epoch 3)")
