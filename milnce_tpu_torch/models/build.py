"""Model factory: ModelConfig -> S3D module (port of
``milnce_tpu/models/build.py``).

A ``.npy``/``.npz`` word table is loaded only when its path exists, as
in the JAX package; otherwise the table is random at the configured
vocabulary size.  ``model.sync_batchnorm`` syncs every BatchNorm's
train-mode statistics over the ranks of the run's group, as the JAX
factory's ``bn_axis_name`` does; without a group it changes nothing.
``model.remat`` recomputes each Inception block in the backward.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from milnce_tpu_torch.config import ModelConfig
from milnce_tpu_torch.models.initializers import init_weights
from milnce_tpu_torch.models.s3dg import S3D, BatchNorm3d


def load_word2vec_table(path: str) -> np.ndarray:
    """A pretrained (V, 300) table from .npy/.npz, or from the reference's
    torch-saved ``word2vec.pth``."""
    if path.endswith((".pth", ".pt", ".tar")):
        return torch.load(path, map_location="cpu", weights_only=False).numpy()
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[list(z.files)[0]]
    return np.load(path)


def build_model(cfg: ModelConfig, seed: int = 0, group=None) -> S3D:
    """Build the S3D on the CPU with weights drawn from ``seed``; the
    caller moves it to its device.  ``group``: the ranks that sync
    BatchNorm under ``cfg.sync_batchnorm``."""
    if cfg.dtype != "float32":
        raise ValueError(f"model.dtype={cfg.dtype!r}: the torch port runs "
                         "float32 only")
    table = None
    vocab_size = cfg.vocab_size
    if cfg.word2vec_path and os.path.exists(cfg.word2vec_path):
        table = load_word2vec_table(cfg.word2vec_path)
        vocab_size = table.shape[0]
    if cfg.conv_impl_map:
        raise ValueError("model.conv_impl_map is not ported yet")
    model = S3D(num_classes=cfg.embedding_dim, gating=cfg.gating,
                use_space_to_depth=cfg.space_to_depth,
                inception_blocks=cfg.inception_blocks,
                vocab_size=vocab_size,
                word_embedding_dim=cfg.word_embedding_dim,
                text_hidden_dim=cfg.text_hidden_dim,
                conv_impl=cfg.conv_impl, remat=cfg.remat)
    init_weights(model, cfg.weight_init, torch.Generator().manual_seed(seed))
    if table is not None:
        with torch.no_grad():
            model.text_module.word_embd.weight.copy_(
                torch.from_numpy(np.asarray(table, np.float32)))
    if cfg.sync_batchnorm:
        sync_batchnorm(model, group)
    return model


def sync_batchnorm(model: S3D, group) -> None:
    """Take every BatchNorm's train-mode statistics over ``group``'s
    ranks (None = this process's batch alone)."""
    for module in model.modules():
        if isinstance(module, BatchNorm3d):
            module.group = group
