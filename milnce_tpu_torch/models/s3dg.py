"""S3D-G (Gated Separable-3D Inception) video tower + sentence tower
(port of ``milnce_tpu/models/s3dg.py``).

The public functions take the JAX package's layout, a ``(B, T, H, W, 3)``
float clip in [0, 1], and permute to torch's NCDHW inside.  Module and
parameter names follow the reference torch model (``conv1/bn1`` and,
for separable convs, ``conv2/bn2``; ``gating.fc``; ``text_module.*``;
``fc``), so a state dict from ``utils/torch_convert.py`` loads with
``strict=True``.

Three places where torch's stock layers differ from the JAX model and
the port follows the JAX model:

- BatchNorm updates its running variance with the *biased* batch
  variance, as Flax does (``nn.BatchNorm3d`` would use the unbiased
  one).  Flax ``momentum=0.9`` is torch ``momentum=0.1``; eps is 1e-5.
- The stem and trunk max pools use the reference's TF-SAME padding,
  which is asymmetric (``lo = (k - s) // 2``, the rest plus the
  ceil-mode tail on the high side): ``F.pad`` with -inf, then
  ``max_pool3d`` with no padding.
- ``space_to_depth`` orders the new channels ``(t2, h2, w2, C)``, the
  JAX model's channels-last order.

``remat=True`` recomputes each Inception block in the backward instead
of keeping its activations (the JAX model's ``nn.remat(InceptionBlock)``)
through ``torch.utils.checkpoint`` called inside ``S3D``'s forward, so
the ``state_dict`` keys do not change.  The recomputation folds nothing
into the running statistics (:func:`frozen_running_stats`): a remat
step leaves them, and ``num_batches_tracked``, as a plain step does.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from milnce_tpu_torch.models.conv3d import Conv3D
from milnce_tpu_torch.models.text import SentenceEmbedding
from milnce_tpu_torch.parallel.dist import all_reduce_sum


def _triple(v) -> tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"expected 3 values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * 3


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm with Flax's running-statistics update.

    Train mode normalizes with the batch's biased statistics (as torch
    does) and folds the *biased* variance into ``running_var`` (torch
    folds the unbiased one).  Eval mode is torch's.

    ``group`` (set by ``models/build.py`` under ``model.sync_batchnorm``)
    takes the train-mode statistics over the batches of every rank, as
    the JAX model's ``bn_axis_name`` does: two-pass, the global mean
    first, then the global centred sum of squares, each an all-reduce
    whose backward sums the cotangents.  ``nn.SyncBatchNorm`` is not
    used: it folds the unbiased variance."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.group = None
        # False inside frozen_running_stats: train mode normalizes with
        # the batch statistics but folds nothing into the running ones
        self.fold = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._forward_synced(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias,
                           training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
            self._fold(mean, var)
        return out

    def _forward_synced(self, x: torch.Tensor) -> torch.Tensor:
        dims = (0, 2, 3, 4)
        count = x.numel() // x.shape[1] * dist.get_world_size(self.group)
        mean = all_reduce_sum(x.sum(dim=dims), self.group) / count
        centred = x - mean[None, :, None, None, None]
        var = all_reduce_sum((centred * centred).sum(dim=dims),
                             self.group) / count
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = (centred * scale[None, :, None, None, None]
               + self.bias[None, :, None, None, None])
        with torch.no_grad():
            self._fold(mean, var)
        return out

    def _fold(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if not self.fold:
            return
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, every :class:`BatchNorm3d` of ``module`` runs its
    train-mode forward as always (batch statistics, synced over its group
    if it has one) but leaves its running statistics and
    ``num_batches_tracked`` alone: a forward that repeats one already
    folded (remat's recomputation, the grad-cache step's second pass)
    must not fold it again."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm3d)]
    before = [m.fold for m in norms]
    for m in norms:
        m.fold = False
    try:
        yield
    finally:
        for m, fold in zip(norms, before):
            m.fold = fold


class SelfGating(nn.Module):
    """Squeeze over (T, H, W) -> fc -> sigmoid -> channel rescale."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4))))
        return weights[:, :, None, None, None] * x


class STConv3D(nn.Module):
    """(Optionally separable) conv + BN + ReLU.  ``separable=True`` with a
    temporal extent > 1 factorizes (t, k, k) into a spatial (1, k, k)
    conv1/bn1 and a temporal (t, 1, 1) conv2/bn2."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 stride=1, padding=0, separable: bool = False,
                 conv_impl: str = "native"):
        super().__init__()
        k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
        self.separable = separable and k[0] != 1
        if self.separable:
            self.conv1 = Conv3D(in_channels, features, (1, k[1], k[2]),
                                (1, s[1], s[2]), (0, p[1], p[2]), conv_impl)
            self.bn1 = BatchNorm3d(features)
            self.conv2 = Conv3D(features, features, (k[0], 1, 1),
                                (s[0], 1, 1), (p[0], 0, 0), conv_impl)
            self.bn2 = BatchNorm3d(features)
        else:
            self.conv1 = Conv3D(in_channels, features, k, s, p, conv_impl)
            self.bn1 = BatchNorm3d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if self.separable:
            x = torch.relu(self.bn2(self.conv2(x)))
        return x


class InceptionBlock(nn.Module):
    """Four branches with per-branch self-gating, concatenated on
    channels: 1x1x1; 1x1x1 -> separable 3x3x3 (twice); 3x3x3 stride-1
    max pool -> 1x1x1."""

    def __init__(self, in_channels: int, n0a: int, n1a: int, n1b: int,
                 n2a: int, n2b: int, n3b: int, gating: bool = True,
                 conv_impl: str = "native"):
        super().__init__()
        c = dict(conv_impl=conv_impl)
        self.conv_b0 = STConv3D(in_channels, n0a, 1, **c)
        self.conv_b1_a = STConv3D(in_channels, n1a, 1, **c)
        self.conv_b1_b = STConv3D(n1a, n1b, 3, padding=1, separable=True,
                                  **c)
        self.conv_b2_a = STConv3D(in_channels, n2a, 1, **c)
        self.conv_b2_b = STConv3D(n2a, n2b, 3, padding=1, separable=True,
                                  **c)
        self.conv_b3_b = STConv3D(in_channels, n3b, 1, **c)
        self.gating = gating
        if gating:
            self.gating_b0 = SelfGating(n0a)
            self.gating_b1 = SelfGating(n1b)
            self.gating_b2 = SelfGating(n2b)
            self.gating_b3 = SelfGating(n3b)
        self.output_dim = n0a + n1b + n2b + n3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.conv_b0(x)
        b1 = self.conv_b1_b(self.conv_b1_a(x))
        b2 = self.conv_b2_b(self.conv_b2_a(x))
        # stride-1 3x3x3 pool with symmetric pad 1 == SAME; torch pads
        # with -inf, as the JAX pool does
        b3 = self.conv_b3_b(F.max_pool3d(x, 3, stride=1, padding=1))
        if self.gating:
            b0, b1 = self.gating_b0(b0), self.gating_b1(b1)
            b2, b3 = self.gating_b2(b2), self.gating_b3(b3)
        return torch.cat([b0, b1, b2, b3], dim=1)


def _tf_same_max_pool(x: torch.Tensor, window, strides) -> torch.Tensor:
    """Reference-exact TF-SAME 3D max pool over (T, H, W) of NCDHW: pad
    ``max(k - s, 0)`` low-first plus the ceil-mode tail on the high side,
    with -inf, then pool unpadded."""
    pads = []
    for size, k, s in zip(x.shape[2:], window, strides):
        pad_along = max(k - s, 0)
        lo = pad_along // 2
        hi = pad_along - lo
        hi += (-(size + lo + hi - k)) % s                 # ceil-mode tail
        pads.append((lo, hi))
    # F.pad takes the last dim first
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    x = F.pad(x, flat, value=float("-inf"))
    return F.max_pool3d(x, tuple(window), tuple(strides))


def space_to_depth(video: torch.Tensor) -> torch.Tensor:
    """2x2x2 space-to-depth on NCDHW: (B, C, T, H, W) ->
    (B, 8C, T/2, H/2, W/2) with channel order (t2, h2, w2, C)."""
    b, c, t, h, w = video.shape
    video = video.reshape(b, c, t // 2, 2, h // 2, 2, w // 2, 2)
    video = video.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return video.reshape(b, 8 * c, t // 2, h // 2, w // 2)


# (name, n0a, n1a, n1b, n2a, n2b, n3b), reference s3dg.py:223-233
_BLOCKS = (("mixed_3b", 64, 96, 128, 16, 32, 32),
           ("mixed_3c", 128, 128, 192, 32, 96, 64),
           ("mixed_4b", 192, 96, 208, 16, 48, 64),
           ("mixed_4c", 160, 112, 224, 24, 64, 64),
           ("mixed_4d", 128, 128, 256, 24, 64, 64),
           ("mixed_4e", 112, 144, 288, 32, 64, 64),
           ("mixed_4f", 256, 160, 320, 32, 128, 128),
           ("mixed_5b", 256, 160, 320, 32, 128, 128),
           ("mixed_5c", 384, 192, 384, 48, 128, 128))
# max pool (window, strides) before block index 2 (maxpool_4a) and 7
# (maxpool_5a)
_POOLS_BEFORE = {2: ((3, 3, 3), (2, 2, 2)), 7: ((2, 2, 2), (2, 2, 2))}


class S3D(nn.Module):
    """S3D-G two-tower model.

    ``forward(video, text, mode, mixed5c)``: video (B, T, H, W, 3) float
    in [0, 1]; text (B', max_words) int.  mode 'all' -> (video (B, D),
    text (B', D)); 'video' -> video embedding, or the 1024-d pooled
    mixed_5c features with ``mixed5c=True``; 'text' -> text embedding;
    'sequence' -> (video sequence (B, T', D), text (B', D)).
    Train or eval behaviour (BatchNorm) follows ``module.train()``.
    ``remat``: recompute each Inception block in the backward (module
    docstring); only where a backward can follow (train mode, grad on)."""

    def __init__(self, num_classes: int = 512, gating: bool = True,
                 use_space_to_depth: bool = False, inception_blocks: int = 9,
                 vocab_size: int = 66250, word_embedding_dim: int = 300,
                 text_hidden_dim: int = 2048, conv_impl: str = "native",
                 remat: bool = False):
        super().__init__()
        if not 1 <= inception_blocks <= 9:
            raise ValueError(
                f"inception_blocks must be in [1, 9], got {inception_blocks}")
        self.use_space_to_depth = use_space_to_depth
        self.inception_blocks = inception_blocks
        self.remat = remat
        c = dict(conv_impl=conv_impl)
        if use_space_to_depth:
            self.conv1 = STConv3D(24, 64, (2, 4, 4), 1, (1, 2, 2), **c)
        else:
            self.conv1 = STConv3D(3, 64, (3, 7, 7), 2, (1, 3, 3), **c)
        self.conv_2b = STConv3D(64, 64, 1, **c)
        self.conv_2c = STConv3D(64, 192, 3, padding=1, separable=True, **c)
        # stem gating, named ``gating`` as in the reference state dict
        self.gating = SelfGating(192) if gating else None
        channels = 192
        self.block_names = []
        for name, *widths in _BLOCKS[:inception_blocks]:
            block = InceptionBlock(channels, *widths, gating=gating, **c)
            self.add_module(name, block)
            self.block_names.append(name)
            channels = block.output_dim
        self.fc = nn.Linear(channels, num_classes)
        self.text_module = SentenceEmbedding(num_classes, vocab_size,
                                             word_embedding_dim,
                                             text_hidden_dim)

    def _trunk(self, video: torch.Tensor) -> torch.Tensor:
        net = video.permute(0, 4, 1, 2, 3)                # NDHWC -> NCDHW
        if self.use_space_to_depth:
            net = space_to_depth(net)
        net = self.conv1(net)
        if self.use_space_to_depth:
            net = net[:, :, 1:, 1:, 1:]                   # s3dg.py:271-272
        net = _tf_same_max_pool(net, (1, 3, 3), (1, 2, 2))    # maxpool_2a
        net = self.conv_2c(self.conv_2b(net))
        if self.gating is not None:
            net = self.gating(net)
        net = _tf_same_max_pool(net, (1, 3, 3), (1, 2, 2))    # maxpool_3a
        for idx, name in enumerate(self.block_names):
            if idx in _POOLS_BEFORE:
                net = _tf_same_max_pool(net, *_POOLS_BEFORE[idx])
            block = self._modules[name]
            if self.remat and self.training and torch.is_grad_enabled():
                net = checkpoint(
                    block, net, use_reentrant=False,
                    context_fn=lambda b=block: (contextlib.nullcontext(),
                                                frozen_running_stats(b)))
            else:
                net = block(net)
        return net

    def forward_video(self, video: torch.Tensor,
                      mixed5c: bool = False) -> torch.Tensor:
        net = self._trunk(video).mean(dim=(2, 3, 4))
        return net if mixed5c else self.fc(net)

    def forward_video_sequence(self, video: torch.Tensor) -> torch.Tensor:
        """Temporal sequence of frame-group embeddings, the view the
        soft-DTW losses align: mixed_5c pooled over space only, then
        ``fc`` -> (B, T', num_classes).  No parameter of its own."""
        net = self._trunk(video).mean(dim=(3, 4))         # (B, C, T')
        return self.fc(net.transpose(1, 2))

    def forward_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_module(tokens)

    def forward(self, video: Optional[torch.Tensor],
                text: Optional[torch.Tensor], mode: str = "all",
                mixed5c: bool = False):
        if mode == "all":
            return self.forward_video(video), self.forward_text(text)
        if mode == "video":
            return self.forward_video(video, mixed5c=mixed5c)
        if mode == "text":
            return self.forward_text(text)
        if mode == "sequence":
            # (video seq (B, T', D), per-candidate text (B', D))
            return self.forward_video_sequence(video), self.forward_text(text)
        raise NotImplementedError(mode)
