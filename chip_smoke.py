#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each fatal on failure:

1. device   -- the card's name and power limit (nvidia-smi), torch and
               CUDA versions; TF32 off for convolutions and matmuls.
2. build    -- nvcc builds the port's kernels from ``milnce_tpu_torch/csrc``
               (``milnce_stream.cu`` and ``softdtw.cu``, side by side) and
               prints each kernel's registers and spills (``-Xptxas -v``).
3. kernels  -- each MIL-NCE stream kernel against its plain PyTorch
               version on the card, values and all four gradients, at the
               recipe shape (B=128, Bg=8192, K=5, D=512), an uneven shape
               (Bg=8191, chunk 1000, K=1), a tiny one, the training run's
               own shape, three that stress the backward kernel's tiling
               (R=33 with D=13, R=640 against Bg=4097, D=700), one that
               splits lse_bwd_cols's streamed loop (B=2048 against Bg=40)
               and one that splits lse_fwd's owned rows and its streamed
               loop with a ragged last tile (B=200 against Bg=3000, K=3);
               then the kernels', the plain versions' and the dense
               PyTorch form's times (median of 20 after warm-up, CUDA
               events) at the recipe shape, beside the card's bound, and
               each kernel launch by launch with TFLOP/s, share of the
               bound, kernel/library ratio and the launch plan its
               wrapper chose.
4. soft-DTW -- each soft-DTW kernel alone against its plain version (the
               forward's value and table; the backward's grad_D, fed the
               same table, under a random cotangent and under a stride-0
               expanded one) at the reference presets, past the
               reference's 1024 cap, past the backward's shared-memory
               ring, at the training shapes and at rectangular and 1x1
               ones, for gamma 0.1 and 1e-5, counting the cases that agree
               bit for bit (the forward's value and R, the backward's
               grad_D); then both kernels' and plain versions' times at
               the four presets and at a full-width training shape (per
               call, CUDA events; the kernel alone on the device,
               torch.profiler; for the forward also its whole call on the
               device, which must be that one kernel, and its launch plan;
               for the backward every kernel of the autograd backward's
               call on the device, and that call) beside the card's bound
               and each kernel's figures before its redesign.
5. reference-- a small model with the chunked loss on the kernels agrees
               with the dense loss: one step's gradients, three steps'
               losses.
6. dtw-ref  -- the same small model with each DTW loss (cdtw, sdtw_cidm,
               sdtw_negative, sdtw_3) on the soft-DTW kernels against the
               plain recurrence: one step's gradients, three steps' losses.
7. train    -- ``run_training`` at full width (9 inception blocks,
               embedding 512, vocab 66250 x 300, text hidden 2048, 32
               frames at 224^2, K=5, 20 words), per-device batch 16, 4
               steps, twice: chunked MIL-NCE on the stream kernels with
               chunk 8, then ``sdtw_3`` on the soft-DTW kernels.  Every
               loss finite, every kernel of each run launched its expected
               count; one more step of each profiled.

Prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# FLOP/s and bytes/s of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): f32 outside the tensor cores, HBM3.
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12
TOL_RTOL, TOL_ATOL = 1e-4, 1e-5     # |kernel - plain| <= atol + rtol*max|plain|
TRAIN_STEPS, TRAIN_BATCH, TRAIN_CHUNK = 4, 16, 8
SOURCES = {"lse_fwd": "milnce_tpu_torch/csrc/milnce_stream.cu",
           "lse_bwd_rows": "milnce_tpu_torch/csrc/milnce_stream.cu",
           "lse_bwd_cols": "milnce_tpu_torch/csrc/milnce_stream.cu",
           "softdtw_fwd": "milnce_tpu_torch/csrc/softdtw.cu",
           "softdtw_bwd": "milnce_tpu_torch/csrc/softdtw.cu"}
REPLACES = {"lse_fwd": "milnce_tpu/ops/milnce_pallas.py:131",
            "lse_bwd_rows": "milnce_tpu/ops/milnce_pallas.py:210",
            "lse_bwd_cols": "milnce_tpu/ops/milnce_pallas.py:210",
            "softdtw_fwd": "milnce_tpu/ops/softdtw_pallas.py:282 (B3), "
                           ":63 (B5), :106 (B7)",
            "softdtw_bwd": "milnce_tpu/ops/softdtw_pallas.py:340 (B4), "
                           ":593 (B6), :489 (B8)"}
# the name of each MIL-NCE kernel's CUDA function, for its device time
KERNEL_KEYS = {"lse_fwd": "lse_fwd_kernel", "lse_bwd_rows": "lse_bwd_kernel",
               "lse_bwd_cols": "lse_bwd_kernel"}
# special-function (exp, log) results per clock per SM on Hopper
H100_SFU_PER_CLOCK_SM = 16
# (label, B, N, M, features): the soft-DTW presets of
# milnce_tpu/ops/softdtw_profile.py, the first timed as the kernels' line
SDTW_PRESETS = [("B3/B4 (1024,32,32)", 1024, 32, 32, 64),
                ("B3/B4 (128,17,15)", 128, 17, 15, 2),
                ("B5/B6 (512,64,64)", 512, 64, 64, 2),
                ("B7/B8 (32,256,256)", 32, 256, 256, 512)]
# timed besides the presets: the full-width sdtw_3 step's video-text
# all-pairs call (B^2 = 256 pairs of T' = 4 by K = 5, D = 512)
SDTW_TRAIN_TIMED = ("train v-t (256,4,5)", 256, 4, 5, 512)
# (label, B, N, M, features, bandwidth): past the reference's 1024 cap, the
# full-width sdtw_3 pairs (B^2 = 256, T' = 4 frames, K = 5 captions),
# rectangular / 1x1 cases, and a length past the backward's shared-memory
# ring (N > bwd_shared_max_n(), 1208 on an H100), with M small so that the
# plain versions take seconds
SDTW_EXTRA = [("B7/B8 past 1024", 2, 1500, 1300, 64, 0),
              ("B7/B8 banded", 2, 2048, 2048, 64, 128),
              ("train v-v", 256, 4, 4, 512, 0),
              ("train v-t", 256, 4, 5, 512, 0),
              ("train t-t", 256, 5, 5, 512, 0),
              ("rect", 5, 7, 3, 8, 0),
              ("rect-T banded", 5, 3, 7, 8, 4),
              ("1x1", 3, 1, 1, 8, 0),
              ("past the ring", 1, 2600, 24, 64, 0)]
# softdtw_bwd before its redesign, on an H100 80GB HBM3 at 700 W (the
# E-writing kernel that read R from global memory each step): ms a call
# and on the device, at the timed shapes
SDTW_BWD_BEFORE = {(1024, 32, 32): (0.1214, 0.0752),
                (128, 17, 15): (0.0661, 0.0325),
                (512, 64, 64): (0.2028, 0.1719),
                (32, 256, 256): (0.5523, 0.5341),
                (256, 4, 5): (0.0631, 0.0077)}
# softdtw_fwd before its redesign, on an H100 80GB HBM3 at 700 W (a block
# a pair, the diagonals read back from global memory, the value copied out
# by a second launch): ms a call and on the device
SDTW_FWD_BEFORE = {(1024, 32, 32): (0.0996, 0.0296),
                   (128, 17, 15): (0.1187, 0.0105),
                   (512, 64, 64): (0.0876, 0.0487),
                   (32, 256, 256): (0.2386, 0.2028),
                   (256, 4, 5): (0.0836, 0.0035)}
DTW_LOSSES = ("cdtw", "sdtw_cidm", "sdtw_negative", "sdtw_3")


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phases
def phase_device():
    from milnce_tpu_torch.train.loop import disable_tf32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(disable_tf32())
    return card


def phase_build():
    from milnce_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build(["milnce_stream", "softdtw"])
    for name, (secs, out) in built.items():
        log(f"built {name}.cu in {secs:.1f} s")
        for line in _ptxas_summary(out):
            log(f"  {line}")
    log(f"build phase: {time.perf_counter() - t0:.1f} s "
        f"({'compiled' if built else 'cached'})")


def _ptxas_summary(out):
    """One line per kernel of nvcc's ``-Xptxas -v`` output: its name
    (demangled where ``c++filt`` is found), registers and spills."""
    entries, name, spill = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            entries.append((name, m.group(1), spill))
            name = None
    names = [n for n, _, _ in entries]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                 for n in names]
    return [f"{n}: {regs} registers; {spill}"
            for n, (_, regs, spill) in zip(names, entries)]


def _case(b, bg, k, d, seed, shared):
    """Embeddings for one shape: the local v/t are the first rows of the
    gathered v_all/t_all (drawn apart when b > bg), or the same tensors
    when ``shared``."""
    rng = np.random.default_rng(seed)
    scale = d ** -0.25                    # logits of unit scale

    def draw(n):
        return torch.tensor(rng.standard_normal((n, d), np.float32) * scale,
                            device="cuda")

    v_all, t_all = draw(bg), draw(bg * k)
    if shared:
        return v_all, t_all, v_all, t_all
    if b > bg:
        return draw(b), draw(b * k), v_all, t_all
    return (v_all[:b].clone(), t_all[:b * k].clone(), v_all, t_all)


def _grads(stream, v, t, v_all, t_all, chunk, g_row, g_col):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (v, t, v_all, t_all)]
    shared = v_all is v
    if shared:
        leaves[2], leaves[3] = leaves[0], leaves[1]
    row, col = stream(*leaves, chunk)
    uniq = leaves[:2] if shared else leaves
    grads = torch.autograd.grad((row, col), uniq, (g_row, g_col))
    return [row.detach(), col.detach(), *grads]


def _err(got, want, scaled=False):
    """Max |got - want| and its limit, atol + rtol * max|want|.  With
    ``scaled`` the atol shrinks with outputs below 1, so that it never
    exceeds what it checks."""
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    atol = TOL_ATOL * min(1.0, peak) if scaled else TOL_ATOL
    return err, atol + TOL_RTOL * peak


def phase_parity():
    """Kernel vs plain at nine shapes; returns the worst error of each
    kernel.  The lses come from lse_fwd, g_v/g_t from lse_bwd_rows and
    g_v_all/g_t_all from lse_bwd_cols; where v_all is v (one device),
    g_v and g_t sum the outputs of both backward kernels.  Beside the
    recipe, uneven, tiny and training shapes, three stress the backward
    kernel's tiles: R = 33 rows (not a multiple of its 32-row tile) with
    D = 13 (not a multiple of 4), R = 640 (the columns direction, B*K)
    against an uneven Bg, and D = 700 near the largest instance; and
    B = 2048 against Bg = 40 gives lse_bwd_cols 2 owned tiles, so its
    streamed loop splits over 16 blocks; B = 200 against Bg = 3000 with
    K = 3 gives lse_fwd's rows launch 4 owned tiles (the last ragged) and
    splits of 3 streamed tiles, the last split of 2 ending on a ragged
    tile (its plans are printed).  The cotangents are of unit
    scale and each limit shrinks with its output (``_err(scaled=True)``),
    so that a kernel returning zeros fails."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    cases = [("recipe", 128, 8192, 5, 512, 816, False),
             ("uneven", 128, 8191, 1, 512, 1000, False),
             ("tiny", 3, 3, 2, 16, 2, True),
             ("train", TRAIN_BATCH, TRAIN_BATCH, 5, 512, TRAIN_CHUNK, True),
             ("d13-r33", 33, 8191, 1, 13, 1000, False),
             ("r640-uneven", 128, 4097, 5, 512, 500, False),
             ("d700", 33, 2048, 5, 700, 256, False),
             ("split", 2048, 40, 1, 512, 40, False),
             ("fwd-split", 200, 3000, 3, 512, 300, False)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {name: 0.0 for name in ms.LAUNCHES}
    for i, (label, b, bg, k, d, chunk, shared) in enumerate(cases):
        v, t, v_all, t_all = _case(b, bg, k, d, 100 + i, shared)
        if label == "fwd-split":
            for r, c in ((b, bg * k), (b * k, bg)):
                log(f"  [{label}] lse_fwd R={r} C={c}: "
                    f"{_plan_line(ms.fwd_plan(r, c, d, sms))}")
        g = torch.Generator(device="cuda").manual_seed(i)
        g_row = torch.randn(b, device="cuda", generator=g)
        g_col = torch.randn(b * k, device="cuda", generator=g)
        got = _grads(ms.milnce_stream_cuda, v, t, v_all, t_all, chunk,
                     g_row, g_col)
        want = _grads(ms.milnce_stream_plain, v, t, v_all, t_all, chunk,
                      g_row, g_col)
        torch.cuda.synchronize()
        names = ["row_lse", "col_lse", "g_v", "g_t", "g_v_all", "g_t_all"]
        owners = [["lse_fwd"]] * 2 + [["lse_bwd_rows"]] * 2 + [
            ["lse_bwd_cols"]] * 2
        if shared:          # v_all is v: g_v and g_t sum both kernels
            names = names[:4]
            owners = owners[:2] + [["lse_bwd_rows", "lse_bwd_cols"]] * 2
        for name, own, a, w in zip(names, owners, got, want):
            err, lim = _err(a, w, scaled=True)
            peak = float(w.abs().max())
            ok = err <= lim and bool(torch.isfinite(a).all())
            log(f"  [{label} B={b} Bg={bg} K={k} D={d} chunk={chunk}] "
                f"{name:8s} max_abs_err {err:.3e} (limit {lim:.3e}, "
                f"max|plain| {peak:.3e}) max_rel_err "
                f"{err / max(peak, 1e-30):.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label} {name}: kernel disagrees with "
                                     f"its plain version ({err} > {lim})")
            for kern in own:
                worst[kern] = max(worst[kern], err)
    return worst


def _time_ms(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _plan_line(plan):
    return (f"instance D<={plan.dmax}, BM={plan.bm}, SN={plan.bn}, "
            f"threads={plan.threads}, grid {plan.row_tiles}x{plan.nsplit}, "
            f"streamed tiles/split {plan.tps} of {plan.col_tiles}, "
            f"{plan.smem_bytes} B shared, scratch {plan.scratch}")


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing():
    """Times of each kernel's pair of launches per step (rows direction +
    columns direction) at the recipe shape, and of each kernel's two
    launches one by one, (R, C) = (128, 40960) and (640, 8192), with its
    launch plan.  Each is timed per call (CUDA events: the wrapper's host
    work and the sum of its split partials included) and on the device
    (torch.profiler: the kernel alone; every kernel of the wrapper's call,
    the combination of the partials included; and every kernel of the
    library call, which the whole call is compared with)."""
    from milnce_tpu_torch.losses.milnce_chunked import milnce_default_chunk
    from milnce_tpu_torch.ops import milnce_stream as ms

    b, bg, k, d = 128, 8192, 5, 512
    chunk = milnce_default_chunk(b, k, bg)
    v, t, v_all, t_all = _case(b, bg, k, d, 7, False)
    row = ms.lse_fwd(v, t_all)
    col = ms.lse_fwd(t, v_all)
    g_row = torch.full((b,), 1.0 / b, device="cuda")
    g_col = torch.full((b * k,), 1.0 / b, device="cuda")
    pairs = [(v, t_all, row, g_row, chunk * k), (t, v_all, col, g_col, chunk)]

    def dense_w(a, bm, lse, g):
        return torch.exp(a @ bm.T - lse[:, None]) * g[:, None]

    def rows_library(a, bm, lse, g):
        return dense_w(a, bm, lse, g) @ bm

    def cols_library(a, bm, lse, g):
        return dense_w(a, bm, lse, g).T @ a

    fns = {
        "lse_fwd": (
            lambda: [ms.lse_fwd(a, bm) for a, bm, *_ in pairs],
            lambda: [ms.lse_plain(a, bm, w) for a, bm, _, _, w in pairs],
            lambda: [torch.logsumexp(a @ bm.T, dim=1) for a, bm, *_ in pairs]),
        "lse_bwd_rows": (
            lambda: [ms.lse_bwd_rows(a, bm, l, g) for a, bm, l, g, _ in pairs],
            lambda: [ms.lse_bwd_rows_plain(a, bm, l, g, w)
                     for a, bm, l, g, w in pairs],
            lambda: [rows_library(a, bm, l, g) for a, bm, l, g, _ in pairs]),
        "lse_bwd_cols": (
            lambda: [ms.lse_bwd_cols(a, bm, l, g) for a, bm, l, g, _ in pairs],
            lambda: [ms.lse_bwd_cols_plain(a, bm, l, g, w)
                     for a, bm, l, g, w in pairs],
            lambda: [cols_library(a, bm, l, g) for a, bm, l, g, _ in pairs]),
    }
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # name: (kernel, plan, library call, FLOPs per logit and depth, floats
    # read and written besides A and B)
    per_launch = {
        "lse_fwd": (lambda a, bm, lse, g: ms.lse_fwd(a, bm), ms.fwd_plan,
                    lambda a, bm, lse, g: torch.logsumexp(a @ bm.T, dim=1),
                    2, lambda r, c: r),
        "lse_bwd_rows": (ms.lse_bwd_rows, ms.rows_plan, rows_library, 4,
                         lambda r, c: 2 * r + r * d),
        "lse_bwd_cols": (ms.lse_bwd_cols, ms.cols_plan, cols_library, 4,
                         lambda r, c: 2 * r + c * d)}
    for name, (kern, plan_of, library, per, extra) in per_launch.items():
        for a, bm, lse, g, _ in pairs:
            r, c = a.shape[0], bm.shape[0]
            plan = plan_of(r, c, d, sms)
            ms_k = _time_ms(lambda: kern(a, bm, lse, g))
            ms_l = _time_ms(lambda: library(a, bm, lse, g))
            dev_k = _device_ms(lambda: kern(a, bm, lse, g),
                               KERNEL_KEYS[name])
            dev_c = _device_ms(lambda: kern(a, bm, lse, g), "")
            dev_l = _device_ms(lambda: library(a, bm, lse, g), "")
            flops = per * r * c * d
            bound_ms, bound_by = _bound(
                flops, 4 * (r * d + c * d + extra(r, c)))
            log(f"  {name} launch R={r} C={c} D={d}: kernel {ms_k:.4f} ms, "
                f"{flops / ms_k / 1e9:.2f} TFLOP/s, {bound_ms / ms_k:.3f} of "
                f"the f32 bound ({bound_ms:.4f} ms, {bound_by}) | library "
                f"{ms_l:.4f} ms, kernel/library {ms_k / ms_l:.3f} | on the "
                f"device: kernel alone {dev_k:.4f} ms ({bound_ms / dev_k:.3f} "
                f"of the bound), whole call {dev_c:.4f} ms, library "
                f"{dev_l:.4f} ms, call/library {dev_c / dev_l:.3f} | plan: "
                f"{_plan_line(plan)}")
    for name, (kern, plain, library) in fns.items():
        flops = nbytes = 0
        for a, bm, *_ in pairs:
            r, c = a.shape[0], bm.shape[0]
            if name == "lse_fwd":
                flops += 2 * r * c * d
                nbytes += 4 * (r * d + c * d + r)
            else:                   # recompute the logits + one product
                flops += 4 * r * c * d
                out_rows = r if name == "lse_bwd_rows" else c
                nbytes += 4 * (r * d + c * d + 2 * r + out_rows * d)
        bound_ms, bound_by = _bound(flops, nbytes)
        ms_k = _time_ms(kern)
        ms_p = _time_ms(plain)
        ms_l = _time_ms(library)
        dev_k = _device_ms(kern, KERNEL_KEYS[name])
        dev_c = _device_ms(kern, "")
        dev_l = _device_ms(library, "")
        out[name] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                         bound_ms=bound_ms, bound_by=bound_by,
                         device_ms=dev_k, call_device_ms=dev_c,
                         library_device_ms=dev_l)
        log(f"  {name}: kernel {ms_k:.4f} ms ({flops / ms_k / 1e9:.2f} "
            f"TFLOP/s, {bound_ms / ms_k:.3f} of the bound) | plain "
            f"{ms_p:.3f} ms | dense torch {ms_l:.4f} ms (kernel/library "
            f"{ms_k / ms_l:.3f}) | on the device: kernel alone "
            f"{dev_k:.4f} ms ({bound_ms / dev_k:.3f} of the bound), whole "
            f"call {dev_c:.4f} ms, dense torch {dev_l:.4f} ms (call/library "
            f"{dev_c / dev_l:.3f}) | bound "
            f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB) per step's pair of launches, B={b} "
            f"Bg={bg} K={k} D={d}")
    return out


def _sdtw_case(b, n, m, feat, gamma, seed):
    """A cost from the port's own distance functions: negative_dot (the
    sdtw_3 default) at gamma 0.1, cosine (the cdtw default) at 1e-5, on
    features of unit scale."""
    from milnce_tpu_torch.ops.softdtw import DIST_FUNCS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, feat), generator=gen, device="cuda") / feat ** 0.5
    y = torch.randn((b, m, feat), generator=gen, device="cuda") / feat ** 0.5
    dist = "negative_dot" if gamma >= 0.1 else "cosine"
    return DIST_FUNCS[dist](x, y).contiguous()


def _table_err(got, want):
    """Error of a forward table: the BIG sentinel cells must be the same
    set, hold the same value to 1e-6 relative, and the real cells are held
    to the usual limit."""
    from milnce_tpu_torch.ops.softdtw import BIG

    big = want >= BIG / 2
    if not torch.equal(big, got >= BIG / 2):
        raise AssertionError("kernel and plain forward tables disagree on "
                             "which cells hold the BIG sentinel")
    if bool(big.any()):
        rel = float(((got - want).abs() / want)[big].max())
        if rel > 1e-6:
            raise AssertionError(f"sentinel cells differ by {rel:.2e} rel")
    return _err(got[~big], want[~big])


def phase_softdtw_parity():
    """Each soft-DTW kernel alone against its plain version: softdtw_fwd
    on the cost (value and table), softdtw_bwd on the plain forward's
    table (grad_D under a random cotangent and under ones(1).expand(B),
    the stride-0 cotangent autograd hands in for ``out.sum()``).  Returns
    the worst error of each kernel."""
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    cases = [(label, b, n, m, f, 0) for label, b, n, m, f in SDTW_PRESETS]
    cases += SDTW_EXTRA
    worst = {name: 0.0 for name in sd.LAUNCHES}
    seed = bitwise = grads = fwd_bitwise = fwds = 0
    for label, b, n, m, feat, band in cases:
        plan = sd.bwd_plan(b, n, m)
        log(f"  [{label}] softdtw_fwd plan: {sd.fwd_plan(b, n, m)}")
        log(f"  [{label}] softdtw_bwd plan: {plan}")
        if label == "past the ring" and plan.ring != "global":
            raise AssertionError(f"{label}: N={n} does not pass the shared "
                                 f"ring (largest N {sd.bwd_shared_max_n()})")
        for gamma in (0.1, 1e-5):
            seed += 1
            D = _sdtw_case(b, n, m, feat, gamma, seed)
            cotangents = {
                "random": torch.randn(b, device="cuda", generator=torch
                                      .Generator(device="cuda")
                                      .manual_seed(seed)),
                "expanded": torch.ones(1, device="cuda").expand(b)}
            val_k, r_k = sd.softdtw_fwd(D, gamma, band)
            val_p, r_p = sd.softdtw_fwd_plain(D, gamma, band)
            torch.cuda.synchronize()
            same = torch.equal(val_k, val_p) and torch.equal(r_k, r_p)
            fwd_bitwise += same
            fwds += 1
            checks = [("softdtw_fwd", f"value{', bitwise' if same else ''}",
                       val_k, _err(val_k, val_p)),
                      ("softdtw_fwd", "R", r_k, _table_err(r_k, r_p))]
            for what, g in cotangents.items():
                got = sd.softdtw_bwd(r_p, g, gamma, band)
                want = sd.softdtw_bwd_plain(r_p, g, gamma, band)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                bitwise += same
                grads += 1
                checks.append(("softdtw_bwd",
                               f"grad_D[{what}{', bitwise' if same else ''}]",
                               got, _err(got, want)))
            line = []
            for kern, what, out, (err, lim) in checks:
                worst[kern] = max(worst[kern], err)
                line.append(f"{what} {err:.2e}/{lim:.2e}")
                finite = bool(torch.isfinite(out).all())
                if err > lim or not finite:
                    raise AssertionError(
                        f"{label} gamma={gamma}: {kern} {what} disagrees with "
                        f"its plain version ({err} > {lim}, finite={finite})")
            log(f"  [{label} B={b} N={n} M={m} band={band} gamma={gamma}] "
                f"err/limit: {', '.join(line)} ok")
    log(f"  softdtw_fwd: value and R bit for bit in {fwd_bitwise} of {fwds} "
        f"cases")
    log(f"  softdtw_bwd: grad_D bit for bit equal to the plain version's in "
        f"{bitwise} of {grads} cases")
    return worst


def _sfu_rate():
    """Special-function results per second: per-clock rate x SMs x the
    card's max SM clock (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return H100_SFU_PER_CLOCK_SM * sms * mhz * 1e6, mhz, sms


def _device_kernels(fn, key, reps=20):
    """Mean device time (ms) per call of ``fn`` of the kernels whose name
    holds ``key``, from torch.profiler, without the host time of its
    wrapper (the kernel alone, or with key '' every kernel the call
    launches), and those kernels' names.  Each kernel counts its mean time
    a launch times its launches a call, rounded, so that a launch the
    profiler did not record (it can miss one of 20) does not read as a
    faster call.  A session that recorded no matching kernel (the
    profiler has dropped a whole session's events on the card) is run
    again, up to three sessions; then it raises, so that a renamed kernel
    cannot read as 0 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and key in e.key]
        if events:
            break
        log(f"  (profiler session {session + 1}: no CUDA kernel whose name "
            f"holds {key!r}; profiling again)")
    else:
        raise AssertionError(f"no CUDA kernel whose name holds {key!r} ran "
                             "under the profiler in three sessions")
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                / e.count * max(1, round(e.count / reps)) for e in events)
    return total / 1e3, sorted(e.key for e in events)


def _device_ms(fn, key, reps=20):
    """The device time of :func:`_device_kernels`."""
    return _device_kernels(fn, key, reps)[0]


def phase_softdtw_timing():
    """Both soft-DTW kernels and their plain versions at the four presets
    and at a full-width training shape (gamma 0.1), beside the bound of
    what the function needs, not of what the kernels move: bytes (forward:
    read D, write the dense (N+1) x (M+1) table R that the backward
    needs; backward: read that R, write grad_D) at the HBM rate, and
    special-function operations (forward 3 exp + 1 log per cell; backward
    the 3 exp of a cell's Cuturi-Blondel weights) at the SFU rate; the
    larger wins.  The backward is timed three ways: the kernel alone on
    the device, every kernel of the autograd backward's call on the
    device, and a call (of ``softdtw_bwd``, and of the autograd backward),
    beside the previous backward's figures.  Returns the first preset's
    numbers."""
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    sfu, mhz, sms = _sfu_rate()
    log(f"  SFU rate {sfu / 1e12:.3f} T/s ({H100_SFU_PER_CLOCK_SM}/clk/SM x "
        f"{sms} SMs x {mhz:.0f} MHz)")
    out = {}
    for label, b, n, m, feat in SDTW_PRESETS + [SDTW_TRAIN_TIMED]:
        D = _sdtw_case(b, n, m, feat, 0.1, 7)
        _, r = sd.softdtw_fwd(D, 0.1)
        g = torch.ones(1, device="cuda").expand(b)
        leaf = D.clone().requires_grad_(True)
        value = sd.softdtw_cuda(leaf, 0.1)

        def autograd_bwd():
            return torch.autograd.grad(value, leaf, g, retain_graph=True)

        cells = b * n * m
        d_bytes = 4 * cells                 # D, and grad_D of its shape
        r_bytes = 4 * b * (n + 1) * (m + 1)
        work = {"softdtw_fwd": (d_bytes + r_bytes, 4 * cells,
                                lambda: sd.softdtw_fwd(D, 0.1),
                                lambda: sd.softdtw_fwd_plain(D, 0.1)),
                "softdtw_bwd": (r_bytes + d_bytes, 3 * cells,
                                lambda: sd.softdtw_bwd(r, g, 0.1),
                                lambda: sd.softdtw_bwd_plain(r, g, 0.1))}
        for name, (nbytes, ops, kern, plain) in work.items():
            t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / sfu
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            ms_k, ms_p = _time_ms(kern), _time_ms(plain)
            dev = _device_ms(kern, f"{name}_kernel")
            extra = {}
            line = (f"  {name} {label}: kernel {ms_k:.4f} ms per call, "
                    f"{dev:.4f} ms on the device")
            if name == "softdtw_fwd":
                call_dev, launched = _device_kernels(kern, "")
                if len(launched) != 1 or name not in launched[0]:
                    raise AssertionError(f"a softdtw_fwd call launched "
                                         f"{launched}, not its one kernel")
                extra = dict(call_device_ms=call_dev)
                old_call, old_dev = SDTW_FWD_BEFORE[(b, n, m)]
                line += (f", whole call {call_dev:.4f} ms on the device "
                         f"(one kernel) (before: {old_call:.4f} per call, "
                         f"{old_dev:.4f} on the device; {old_dev / dev:.2f}x)"
                         f" | plan {sd.fwd_plan(b, n, m)}")
            if name == "softdtw_bwd":
                extra = dict(autograd_ms=_time_ms(autograd_bwd),
                             autograd_device_ms=_device_ms(autograd_bwd, ""))
                old_call, old_dev = SDTW_BWD_BEFORE[(b, n, m)]
                line += (f" (before: {old_call:.4f} per call, {old_dev:.4f} "
                         f"on the device; {old_dev / dev:.2f}x) | autograd "
                         f"backward {extra['autograd_ms']:.4f} ms per call, "
                         f"every kernel of it "
                         f"{extra['autograd_device_ms']:.4f} ms on the "
                         f"device | plan {sd.bwd_plan(b, n, m)}")
            log(f"{line} | plain {ms_p:.3f} ms | bound {bound_ms:.5f} ms "
                f"({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} M SFU "
                f"ops) | {n + m - 1} dependent diagonal steps, "
                f"{dev / (n + m - 1) * 1e3:.4f} us each on the device")
            if name not in out:
                out[name] = dict(ms=ms_k, plain_ms=ms_p, library_ms=None,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 device_ms=dev, shape=[b, n, m, feat],
                                 **extra)
    return out


def _small_cfg(impl, backend):
    from milnce_tpu_torch.config import tiny_preset

    cfg = tiny_preset()
    cfg.parallel.platform = "cuda"
    cfg.model.inception_blocks = 2
    cfg.data.num_frames, cfg.data.video_size = 8, 64
    cfg.data.num_candidates = 3
    cfg.data.synthetic_num_samples = 24
    cfg.train.batch_size = 8
    cfg.train.max_steps = 3
    cfg.train.n_display = 1
    cfg.loss.milnce_impl, cfg.loss.milnce_backend = impl, backend
    cfg.loss.milnce_chunk = 3
    return cfg


def phase_reference():
    """A small model on the card, chunked loss on the kernels against the
    dense loss, with cuDNN held deterministic so that the loss is the only
    difference: (1) every parameter's gradient of one step, within
    1e-5 + 1e-4 * max|dense gradient| per tensor; (2) the losses of three
    training steps (warmup gives the first step lr 0, so the third loss is
    the first that sees an update), within rel 2e-4.  Parameters after
    Adam are not compared element by element: Adam turns last-bit noise in
    a near-zero gradient into a visible part of an lr-sized step."""
    from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train.loop import run_training

    torch.backends.cudnn.deterministic = True
    try:
        cfg = _small_cfg("chunked", "cuda")
        model = build_model(cfg.model, seed=3).cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(3)
        d = cfg.data
        video = torch.rand((cfg.train.batch_size, d.num_frames, d.video_size,
                            d.video_size, 3), generator=gen, device="cuda")
        text = torch.randint(1, cfg.model.vocab_size,
                             (cfg.train.batch_size * d.num_candidates,
                              d.max_words), generator=gen, device="cuda")
        grads = {}
        for impl in ("dense", "chunked"):
            cfg.loss.milnce_impl = impl
            model.zero_grad(set_to_none=True)
            build_milnce_loss(cfg.loss)(*model(video, text)).backward()
            grads[impl] = {n: p.grad.clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}
        worst = max(float((grads["chunked"][n] - g).abs().max())
                    / (1e-5 + 1e-4 * float(g.abs().max()))
                    for n, g in grads["dense"].items())
        log(f"  one step's gradients, {len(grads['dense'])} tensors: worst "
            f"|chunked - dense| / limit = {worst:.3e}")
        runs = {}
        for impl, backend in (("dense", "auto"), ("chunked", "cuda")):
            losses = []
            run_training(_small_cfg(impl, backend), log=lambda _m: None,
                         on_step=lambda _s, _t, loss: losses.append(loss))
            runs[impl] = losses
    finally:
        torch.backends.cudnn.deterministic = False
    ld, lc = runs["dense"], runs["chunked"]
    err = max(abs(a - b) / abs(b) for a, b in zip(lc, ld))
    log(f"  losses dense {ld} chunked/cuda {lc}; max rel diff {err:.2e}")
    if not (worst <= 1.0 and len(lc) == len(ld) == 3 and err <= 2e-4
            and all(map(math.isfinite, lc))):
        raise AssertionError("chunked/cuda training disagrees with dense")


def phase_dtw_reference():
    """The small model with each DTW loss, the soft-DTW kernels
    (sdtw_backend=cuda) against the plain recurrence (scan), cuDNN held
    deterministic: (1) every parameter's gradient of one step, within
    1e-5 + 1e-4 * max|scan gradient| per tensor, with non-constant clip
    start times so that sdtw_cidm's interval terms are live; (2) the
    losses of three training steps, within rel 2e-4."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.train.loop import run_training
    from milnce_tpu_torch.train.step import _sequence_loss

    torch.backends.cudnn.deterministic = True
    try:
        for name in DTW_LOSSES:
            cfg = _small_cfg("dense", "auto")
            cfg.loss.name = name
            bsz, d = cfg.train.batch_size, cfg.data
            model = build_model(cfg.model, seed=3).cuda().train()
            gen = torch.Generator(device="cuda").manual_seed(3)
            video = torch.rand((bsz, d.num_frames, d.video_size,
                                d.video_size, 3), generator=gen,
                               device="cuda")
            text = torch.randint(1, cfg.model.vocab_size,
                                 (bsz * d.num_candidates, d.max_words),
                                 generator=gen, device="cuda")
            start = torch.arange(bsz, dtype=torch.float32, device="cuda") * 7
            grads, runs = {}, {}
            sd.reset_launches()
            for backend in ("scan", "cuda"):
                cfg.loss.sdtw_backend = backend
                model.zero_grad(set_to_none=True)
                v_seq, t_embd = model(video, text, mode="sequence")
                t_seq = t_embd.reshape(bsz, -1, t_embd.shape[-1])
                _sequence_loss(cfg.loss, v_seq, t_seq, start).backward()
                grads[backend] = {n: p.grad.clone()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}
            launched = dict(sd.LAUNCHES)
            worst = max(float((grads["cuda"][n] - g).abs().max())
                        / (1e-5 + 1e-4 * float(g.abs().max()))
                        for n, g in grads["scan"].items())
            for backend in ("scan", "cuda"):
                cfg.loss.sdtw_backend = backend
                losses = []
                run_training(cfg, log=lambda _m: None,
                             on_step=lambda _s, _t, loss: losses.append(loss))
                runs[backend] = losses
            ls, lc = runs["scan"], runs["cuda"]
            err = max(abs(a - b) / abs(b) for a, b in zip(lc, ls))
            log(f"  {name}: {len(grads['scan'])} gradients, worst |cuda - "
                f"scan| / limit {worst:.3e}; kernel launches {launched}; "
                f"losses scan {ls} cuda {lc}, max rel diff {err:.2e}")
            if not (worst <= 1.0 and min(launched.values()) > 0
                    and len(lc) == len(ls) == 3 and err <= 2e-4
                    and all(map(math.isfinite, lc))):
                raise AssertionError(f"{name}: the soft-DTW kernels disagree "
                                     "with the plain recurrence in training")
    finally:
        torch.backends.cudnn.deterministic = False


def _stream_loss(loss):
    """Chunked MIL-NCE on the stream kernels."""
    loss.milnce_impl, loss.milnce_backend = "chunked", "cuda"
    loss.milnce_chunk = TRAIN_CHUNK


def _sdtw_loss(loss):
    """The soft-DTW losses on their kernels."""
    loss.sdtw_backend = "cuda"


def _full_cfg(loss_name, edit):
    """The full-width training configuration with the loss ``edit``
    applies: TRAIN_STEPS steps at batch TRAIN_BATCH on synthetic data."""
    from milnce_tpu_torch.config import full_preset

    cfg = full_preset()
    cfg.parallel.platform = "cuda"
    cfg.data.synthetic = True
    cfg.data.synthetic_num_samples = TRAIN_BATCH * TRAIN_STEPS
    cfg.train.batch_size = TRAIN_BATCH
    cfg.train.max_steps = TRAIN_STEPS
    cfg.train.n_display = 1
    cfg.loss.name = loss_name
    edit(cfg.loss)
    return cfg


def _train_full(loss_name, edit, counters, per_step):
    """``run_training`` on ``_full_cfg(loss_name, edit)``, every launch
    counter reset just before and read just after.  Each kernel in
    ``per_step`` must have launched that many times per step.  Returns
    (result, config, the launches of the run)."""
    from milnce_tpu_torch.train.loop import run_training

    cfg = _full_cfg(loss_name, edit)
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    res = run_training(cfg, log=lambda m: log(f"  {m}"),
                       on_step=lambda s, secs, loss: steps.append(
                           (s, secs, loss)))
    launches = {k: v for counter in counters
                for k, v in counter.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    for s, secs, loss in steps:
        log(f"  step {s}: {secs:.3f} s, loss {loss:.6f}")
    later = [secs for _, secs, _ in steps[1:]]
    log(f"  steps/s after the first step: {len(later) / sum(later):.4f} "
        f"(first step {steps[0][1]:.3f} s); peak memory allocated "
        f"{peak / 2 ** 30:.3f} GiB; launches {launches}")
    if res.steps != TRAIN_STEPS or not all(math.isfinite(x[2]) for x in steps):
        raise AssertionError(f"training failed: {steps}")
    expected = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    if launches != expected:
        raise AssertionError(f"expected launches {expected} in "
                             f"{TRAIN_STEPS} steps, got {launches}")
    return res, cfg, launches


def phase_train():
    """Chunked MIL-NCE on the stream kernels: each kernel launches twice a
    step (rows and columns direction)."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.train.step import make_video_embed_fn

    res, cfg, launches = _train_full("milnce", _stream_loss, (ms, sd),
                                     {k: 2 for k in ms.LAUNCHES})
    clip = torch.zeros((2, 32, 224, 224, 3), dtype=torch.uint8, device="cuda")
    emb = make_video_embed_fn(res.model)(clip)
    if emb.shape != (2, 512) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"video embedding {tuple(emb.shape)} not finite")
    _profile_step(res.model, cfg)
    return launches


def phase_train_sdtw3():
    """sdtw_3 on the soft-DTW kernels: 3 NCE terms, each one DP over the B
    positive pairs and one over the B^2 pairs (pair_chunk 0), so 6 forward
    and 6 backward launches a step."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    res, cfg, launches = _train_full("sdtw_3", _sdtw_loss, (ms, sd),
                                     {k: 6 for k in sd.LAUNCHES})
    clip = torch.zeros((2, 32, 224, 224, 3), dtype=torch.uint8, device="cuda")
    text = torch.ones((2 * cfg.data.num_candidates, cfg.data.max_words),
                      dtype=torch.int64, device="cuda")
    with torch.no_grad():
        res.model.eval()
        v_seq, t_embd = res.model(clip.float() / 255.0, text, mode="sequence")
    if v_seq.shape != (2, 4, 512) or t_embd.shape != (10, 512) or not (
            bool(torch.isfinite(v_seq).all())):
        raise AssertionError(f"sequence embeddings {tuple(v_seq.shape)}, "
                             f"{tuple(t_embd.shape)} not as expected")
    _profile_step(res.model, cfg)
    return launches


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "softdtw" in low:
        return "soft-DTW kernels"
    if "lse_" in low:
        return "milnce stream kernels"
    if "conv" in low or "xmma" in low or "gemm" in low or "cudnn" in low \
            or "implicit" in low or "wgrad" in low or "dgrad" in low:
        return "convolution / matmul"
    if "norm" in low or "welford" in low or "bn_" in low:
        return "batchnorm"
    if "adam" in low or "foreach" in low:
        return "optimizer"
    return "other elementwise / reduction"


def _profile_step(model, cfg):
    """One more full-width train step under torch.profiler, after the
    counted run (its launches are not in the counts): device time by
    kernel group and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from milnce_tpu_torch.train.schedule import build_schedule_total
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import make_train_step

    optimizer, lr = build_optimizer(model, cfg.optim,
                                    build_schedule_total(cfg.optim, 100))
    step = make_train_step(model, optimizer, cfg.loss, lr_scheduler=lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = cfg.data
    video = torch.randint(0, 255, (TRAIN_BATCH, d.num_frames, d.video_size,
                                   d.video_size, 3), generator=gen,
                          dtype=torch.uint8, device="cuda")
    text = torch.randint(1, cfg.model.vocab_size,
                         (TRAIN_BATCH * d.num_candidates, d.max_words),
                         generator=gen, device="cuda")
    start = torch.arange(TRAIN_BATCH, dtype=torch.float32, device="cuda")
    step(video, text, start)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(video, text, start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:     # kernels only, not the
            continue                               # CPU ops that launch them
        dev = getattr(evt, "self_device_time_total",
                      getattr(evt, "self_cuda_time_total", 0)) / 1e3
        rows.append((dev, evt.key, evt.count))
        grp = _kernel_group(evt.key)
        groups[grp] = groups.get(grp, 0.0) + dev
    busy = sum(groups.values())
    log(f"  profiled step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for grp, ms_ in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"    {grp:32s} {ms_:9.2f} ms  {ms_ / busy:.3f}")
    for dev, key, count in sorted(rows, reverse=True)[:12]:
        log(f"    top: {dev:9.2f} ms x{count:<4d} {key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        import milnce_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    log("== device")
    card = phase_device()
    log("== build")
    phase_build()
    log("== MIL-NCE kernels vs plain")
    worst = phase_parity()
    log("== MIL-NCE kernel timing")
    times = phase_timing()
    log("== soft-DTW kernels vs plain")
    worst.update(phase_softdtw_parity())
    log("== soft-DTW kernel timing")
    times.update(phase_softdtw_timing())
    log("== reference (small model, chunked/cuda vs dense)")
    phase_reference()
    log("== dtw reference (small model, soft-DTW cuda vs scan)")
    phase_dtw_reference()
    log("== train (full width, MIL-NCE)")
    launches = phase_train()
    log("== train (full width, sdtw_3)")
    sdtw_launches = phase_train_sdtw3()
    launches.update({k: sdtw_launches[k] for k in ("softdtw_fwd",
                                                   "softdtw_bwd")})
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=worst[name], **times[name])
               for name in SOURCES]
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}; total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
