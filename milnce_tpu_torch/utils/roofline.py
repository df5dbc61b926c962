"""Analytic FLOPs / bytes / arithmetic-intensity model of S3D-G (port of
``milnce_tpu/utils/roofline.py``: the same stage table and FLOP counts).

Consumers: the train loop's live MFU gauge (``train_step_flops`` over
``device_peak_flops``), and ``python -m milnce_tpu_torch.utils.roofline``,
the per-stage roofline table on the H100.

The stage list mirrors ``models/s3dg.py`` (reference s3dg.py:207-328)
structurally: conv1 -> conv_2b -> conv_2c -> 9 Inception blocks with the
reference channel plan, TF-SAME pools between.  Accuracy contract:
convolution/dense FLOPs are exact (2 * out_elems * fan_in); elementwise
work (BN, ReLU, gating mults, pools, softmax) is counted as bytes but
NOT flops.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

# FLOP/s and bytes/s of one H100 SXM at its 700 W limit (NVIDIA H100
# Tensor Core GPU data sheet): f32 outside the tensor cores (the port's
# model runs f32 with TF32 off), HBM3.
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12
# f32 FLOP/s outside the tensor cores of each H100 form factor (the same
# data sheet), by a substring of ``torch.cuda.get_device_name()``; the
# SXM card's name ("NVIDIA H100 80GB HBM3") matches only the last key.
PEAK_F32_FLOPS_BY_NAME = {"h100 pcie": 51e12, "h100 nvl": 60e12,
                          "h100": H100_F32_FLOPS}


def device_peak_flops(device_name: str = "") -> Optional[float]:
    """Peak FLOP/s of one card for the dtype the port's model runs in (f32,
    TF32 off), for a ``torch.cuda.get_device_name()`` naming an H100;
    None for any other card or the CPU, and the MFU gauge stays unset.
    ``MILNCE_PEAK_FLOPS`` overrides, as in the JAX package: how hermetic
    CPU tests get a deterministic MFU denominator."""
    env = os.environ.get("MILNCE_PEAK_FLOPS", "")
    if env:
        return float(env)
    name = device_name.lower()
    for key, val in PEAK_F32_FLOPS_BY_NAME.items():
        if key in name:
            return val
    return None


def mfu(flops_per_step: float, steps_per_sec: float,
        peak_per_chip: float, n_chips: int) -> float:
    """Model FLOPs utilization: achieved FLOP/s over the fleet's peak.
    ``flops_per_step`` counts the WHOLE sharded step (the convention of
    every FLOPs source in this module), so the denominator scales by
    chip count (cards here).  The train loop's live display-cadence
    gauge."""
    return flops_per_step * steps_per_sec / (peak_per_chip * n_chips)

# (out0a, out1a, out1b, out2a, out2b, out3b) per block — s3dg.py:223-233
INCEPTION_PLAN = [
    ("mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("mixed_5c", (384, 192, 384, 48, 128, 128)),
]
# TF-SAME pools before these block indices: window/stride (s3dg.py ordering)
POOLS_BEFORE = {2: ((3, 3, 3), (2, 2, 2)), 7: ((2, 2, 2), (2, 2, 2))}


@dataclasses.dataclass
class Stage:
    name: str
    out_shape: Tuple[int, ...]          # (B, T, H, W, C)
    flops: float                        # fwd multiply-adds * 2 (conv/dense)
    bytes: float                        # in + out + weights, at `dtype_bytes`

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else 0.0


def _valid_taps(size: int, k: int, s: int, pad: int) -> Tuple[int, int]:
    """(output size, total VALID kernel taps over all outputs) for one
    spatial dim with symmetric padding.  Multiplications against the
    zero-padding are not real work — XLA's cost analysis agrees — and at
    small dims (4 frames, 3-tap temporal convs) the difference is ~17%,
    so the naive out*k count would overstate FLOPs."""
    out = (size + 2 * pad - k) // s + 1
    taps = 0
    for o in range(out):
        start = o * s - pad
        taps += min(start + k, size) - max(start, 0)
    return out, taps


def _conv_stage(name, in_shape, out_c, kernel, stride, dtype_bytes) -> Stage:
    b, t, h, w, c = in_shape
    # torch-style symmetric padding keeping ceil(dim/stride), as every
    # conv in this trunk uses (s3dg.py paddings)
    dims = [_valid_taps(size, k, s, k // 2)
            for size, k, s in zip((t, h, w), kernel, stride)]
    (ot, vt), (oh, vh), (ow, vw) = dims
    out_elems = b * ot * oh * ow * out_c
    # valid-tap sums factorize across dims: total MACs = B*Cin*Cout*∏Σv
    flops = 2.0 * b * c * out_c * vt * vh * vw
    weights = kernel[0] * kernel[1] * kernel[2] * c * out_c
    return Stage(name, (b, ot, oh, ow, out_c), flops,
                 dtype_bytes * (b * t * h * w * c + out_elems + weights))


def _sep_conv(name, in_shape, out_c, k, stride, dtype_bytes) -> List[Stage]:
    """Separable (t,k,k) = spatial (1,k,k) + temporal (t,1,1), each its
    own conv+BN+ReLU (s3dg.py:74-99)."""
    spatial = _conv_stage(f"{name}.spatial", in_shape, out_c, (1, k, k),
                          (1, stride[1], stride[2]), dtype_bytes)
    temporal = _conv_stage(f"{name}.temporal", spatial.out_shape, out_c,
                           (k, 1, 1), (stride[0], 1, 1), dtype_bytes)
    return [spatial, temporal]


def _pool_shape(shape, window, stride):
    b, t, h, w, c = shape
    return (b, -(-t // stride[0]), -(-h // stride[1]), -(-w // stride[2]), c)


def _inception(name, in_shape, plan, dtype_bytes) -> List[Stage]:
    c0, c1a, c1b, c2a, c2b, c3b = plan
    stages = [_conv_stage(f"{name}.b0", in_shape, c0, (1, 1, 1), (1, 1, 1),
                          dtype_bytes),
              _conv_stage(f"{name}.b1a", in_shape, c1a, (1, 1, 1), (1, 1, 1),
                          dtype_bytes)]
    stages += _sep_conv(f"{name}.b1b", stages[-1].out_shape, c1b, 3,
                        (1, 1, 1), dtype_bytes)
    stages.append(_conv_stage(f"{name}.b2a", in_shape, c2a, (1, 1, 1),
                              (1, 1, 1), dtype_bytes))
    stages += _sep_conv(f"{name}.b2b", stages[-1].out_shape, c2b, 3,
                        (1, 1, 1), dtype_bytes)
    stages.append(_conv_stage(f"{name}.b3b", in_shape, c3b, (1, 1, 1),
                              (1, 1, 1), dtype_bytes))
    out_c = c0 + c1b + c2b + c3b
    b, t, h, w, _ = in_shape
    # self-gating: 4 tiny dense (C->C) — flops negligible, bytes counted
    stages.append(Stage(f"{name}.concat+gate", (b, t, h, w, out_c),
                        2.0 * b * out_c * out_c * 4,
                        dtype_bytes * 2 * b * t * h * w * out_c))
    return stages


def s3d_video_stages(batch: int, frames: int, size: int,
                     space_to_depth: bool = False,
                     inception_blocks: int = 9,
                     dtype_bytes: int = 2) -> List[Stage]:
    """Forward conv trunk as a stage list (conv1 .. mixed_5c)."""
    stages: List[Stage] = []
    if space_to_depth:
        shape = (batch, frames // 2, size // 2, size // 2, 24)
        conv1 = _conv_stage("conv1(s2d)", shape, 64, (2, 4, 4),
                            (1, 1, 1), dtype_bytes)
        # the model crops the even-kernel conv's +1 overhang (s3dg.py
        # forward: net[:, 1:, 1:, 1:]) — downstream stages see size//2
        b, ot, oh, ow, c = conv1.out_shape
        conv1.out_shape = (b, ot - 1, oh - 1, ow - 1, c)
        stages.append(conv1)
    else:
        shape = (batch, frames, size, size, 3)
        stages.append(_conv_stage("conv1", shape, 64, (3, 7, 7), (2, 2, 2),
                                  dtype_bytes))
    shape = _pool_shape(stages[-1].out_shape, (1, 3, 3), (1, 2, 2))
    stages.append(_conv_stage("conv_2b", shape, 64, (1, 1, 1), (1, 1, 1),
                              dtype_bytes))
    stages += _sep_conv("conv_2c", stages[-1].out_shape, 192, 3, (1, 1, 1),
                        dtype_bytes)
    shape = _pool_shape(stages[-1].out_shape, (1, 3, 3), (1, 2, 2))
    for idx, (name, plan) in enumerate(INCEPTION_PLAN[:inception_blocks]):
        if idx in POOLS_BEFORE:
            shape = _pool_shape(shape, *POOLS_BEFORE[idx])
        block = _inception(name, shape, plan, dtype_bytes)
        stages += block
        shape = block[-1].out_shape
    return stages


def video_fwd_flops(batch: int, frames: int, size: int,
                    space_to_depth: bool = False,
                    inception_blocks: int = 9,
                    embedding_dim: int = 512) -> float:
    stages = s3d_video_stages(batch, frames, size, space_to_depth,
                              inception_blocks)
    trunk_c = stages[-1].out_shape[-1]
    return (sum(s.flops for s in stages)
            + 2.0 * batch * trunk_c * embedding_dim)          # final fc


def text_fwd_flops(rows: int, words: int, word_dim: int = 300,
                   hidden: int = 2048, embedding_dim: int = 512) -> float:
    """Frozen embed lookup (0 flops) -> dense(word_dim->hidden) per word
    -> word-max -> dense(hidden->embd) (s3dg.py:196-204)."""
    return (2.0 * rows * words * word_dim * hidden
            + 2.0 * rows * hidden * embedding_dim)


def milnce_logits_flops(batch: int, k_candidates: int,
                        embedding_dim: int = 512) -> float:
    """fwd+bwd FLOPs of the MIL-NCE logits matmul — the one QUADRATIC-in-
    batch term of the step (loss.py:11-17); callers rescaling a measured
    step count across batch sizes must scale this term separately."""
    return 3.0 * 2.0 * batch * batch * k_candidates * embedding_dim


def train_step_flops(batch: int, frames: int, size: int, k_candidates: int,
                     words: int, space_to_depth: bool = False,
                     inception_blocks: int = 9,
                     embedding_dim: int = 512,
                     word_dim: int = 300, hidden: int = 2048) -> float:
    """Full fwd+bwd step estimate: backward of a conv stack costs ~2x the
    forward (grad-wrt-input + grad-wrt-weights matmuls), so fwd+bwd = 3x
    fwd model flops; the MIL-NCE logits matmul (B*Bg*K*D, both directions
    counted once — loss.py:11-17) rides on top.  Optimizer/BN/pool vector
    work is excluded (sub-1%)."""
    model = (video_fwd_flops(batch, frames, size, space_to_depth,
                             inception_blocks, embedding_dim)
             + text_fwd_flops(batch * k_candidates, words, word_dim, hidden,
                              embedding_dim))
    return 3.0 * model + milnce_logits_flops(batch, k_candidates,
                                             embedding_dim)


def roofline_table(batch: int, frames: int, size: int,
                   space_to_depth: bool = False,
                   peak_flops: float = H100_F32_FLOPS,
                   hbm_bw: float = H100_HBM_BYTES,
                   dtype_bytes: int = 4) -> str:
    """Markdown per-stage table: FLOPs, bytes, intensity, bound, and the
    roofline-attained fraction of peak for each stage (defaults: the
    H100 SXM's f32 rate outside the tensor cores and its HBM3 rate, f32
    operands)."""
    ridge = peak_flops / hbm_bw
    stages = s3d_video_stages(batch, frames, size, space_to_depth,
                              dtype_bytes=dtype_bytes)
    lines = [f"| stage | out shape | GFLOP | MB | AI (F/B) | bound | "
             f"roofline max MFU |",
             "|---|---|---|---|---|---|---|"]
    for s in stages:
        bound = "FMA" if s.intensity >= ridge else "HBM"
        attained = min(1.0, s.intensity / ridge)
        lines.append(
            f"| {s.name} | {'x'.join(map(str, s.out_shape))} | "
            f"{s.flops / 1e9:.2f} | {s.bytes / 1e6:.1f} | "
            f"{s.intensity:.0f} | {bound} | {attained:.0%} |")
    total_f = sum(s.flops for s in stages)
    total_b = sum(s.bytes for s in stages)
    # weighted attainable MFU: each stage runs at min(peak, AI*bw)
    time = sum(max(s.flops / peak_flops, s.bytes / hbm_bw) for s in stages)
    lines.append(f"| **total fwd trunk** | | {total_f / 1e9:.1f} | "
                 f"{total_b / 1e6:.1f} | {total_f / total_b:.0f} | | "
                 f"{total_f / time / peak_flops:.0%} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    for s2d in (False, True):
        print(f"\n## 32f@224, batch {batch}, f32, "
              f"{'s2d stem' if s2d else 'plain stem'} (H100 SXM roofline)\n")
        print(roofline_table(batch, 32, 224, space_to_depth=s2d))
