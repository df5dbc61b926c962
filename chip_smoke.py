#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each fatal on failure:

1. device   -- the card's name and power limit (nvidia-smi), torch and
               CUDA versions; TF32 off for convolutions and matmuls.
2. build    -- nvcc builds the port's kernels from ``milnce_tpu_torch/csrc``
               (``milnce_stream.cu`` and ``softdtw.cu``, side by side).
3. kernels  -- each MIL-NCE stream kernel against its plain PyTorch
               version on the card, values and all four gradients, at the
               recipe shape (B=128, Bg=8192, K=5, D=512), an uneven shape
               (Bg=8191, chunk 1000, K=1), a tiny one and the training
               run's own shape; then the kernels', the plain versions' and
               the dense PyTorch form's times (median of 20 after warm-up,
               CUDA events) at the recipe shape, beside the card's bound.
4. soft-DTW -- each soft-DTW kernel alone against its plain version (the
               forward's value and table; the backward's E-matrix and
               gradient, fed the same table) at the reference presets, past
               the reference's 1024 cap, at the training shapes and at
               rectangular and 1x1 ones, for gamma 0.1 and 1e-5; then both
               kernels' and plain versions' times at the four presets and
               at a full-width training shape (per call, CUDA events; and
               the kernel alone on the device, torch.profiler) beside the
               card's bound.
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
# full-width sdtw_3 pairs (B^2 = 256, T' = 4 frames, K = 5 captions), and
# rectangular / 1x1 cases
SDTW_EXTRA = [("B7/B8 past 1024", 2, 1500, 1300, 64, 0),
              ("B7/B8 banded", 2, 2048, 2048, 64, 128),
              ("train v-v", 256, 4, 4, 512, 0),
              ("train v-t", 256, 4, 5, 512, 0),
              ("train t-t", 256, 5, 5, 512, 0),
              ("rect", 5, 7, 3, 8, 0),
              ("rect-T banded", 5, 3, 7, 8, 4),
              ("1x1", 3, 1, 1, 8, 0)]
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
        for line in out.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"  {line.strip()}")
    log(f"build phase: {time.perf_counter() - t0:.1f} s "
        f"({'compiled' if built else 'cached'})")


def _case(b, bg, k, d, seed, shared):
    """Embeddings for one shape: the local v/t are the first rows of the
    gathered v_all/t_all, or the same tensors when ``shared``."""
    rng = np.random.default_rng(seed)
    scale = d ** -0.25                    # logits of unit scale
    v_all = torch.tensor(rng.standard_normal((bg, d), np.float32) * scale,
                         device="cuda")
    t_all = torch.tensor(rng.standard_normal((bg * k, d), np.float32) * scale,
                         device="cuda")
    if shared:
        return v_all, t_all, v_all, t_all
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


def _err(got, want):
    err = float((got - want).abs().max())
    lim = TOL_ATOL + TOL_RTOL * float(want.abs().max())
    return err, lim


def phase_parity():
    """Kernel vs plain at four shapes; returns the worst error of each
    kernel.  The lses come from lse_fwd, g_v/g_t from lse_bwd_rows and
    g_v_all/g_t_all from lse_bwd_cols; where v_all is v (one device),
    g_v and g_t sum the outputs of both backward kernels."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    cases = [("recipe", 128, 8192, 5, 512, 816, False),
             ("uneven", 128, 8191, 1, 512, 1000, False),
             ("tiny", 3, 3, 2, 16, 2, True),
             ("train", TRAIN_BATCH, TRAIN_BATCH, 5, 512, TRAIN_CHUNK, True)]
    worst = {name: 0.0 for name in ms.LAUNCHES}
    for i, (label, b, bg, k, d, chunk, shared) in enumerate(cases):
        v, t, v_all, t_all = _case(b, bg, k, d, 100 + i, shared)
        g = torch.Generator(device="cuda").manual_seed(i)
        g_row = torch.randn(b, device="cuda", generator=g) / b
        g_col = torch.randn(b * k, device="cuda", generator=g) / b
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
            err, lim = _err(a, w)
            ok = err <= lim and bool(torch.isfinite(a).all())
            log(f"  [{label} B={b} Bg={bg} K={k} D={d} chunk={chunk}] "
                f"{name:8s} max_abs_err {err:.3e} (limit {lim:.3e}) "
                f"max_rel_err {err / max(float(w.abs().max()), 1e-30):.3e} "
                f"{'ok' if ok else 'FAIL'}")
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


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing():
    """Times of each kernel's pair of launches per step (rows direction +
    columns direction) at the recipe shape."""
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

    fns = {
        "lse_fwd": (
            lambda: [ms.lse_fwd(a, bm) for a, bm, *_ in pairs],
            lambda: [ms.lse_plain(a, bm, w) for a, bm, _, _, w in pairs],
            lambda: [torch.logsumexp(a @ bm.T, dim=1) for a, bm, *_ in pairs]),
        "lse_bwd_rows": (
            lambda: [ms.lse_bwd_rows(a, bm, l, g) for a, bm, l, g, _ in pairs],
            lambda: [ms.lse_bwd_rows_plain(a, bm, l, g, w)
                     for a, bm, l, g, w in pairs],
            lambda: [dense_w(a, bm, l, g) @ bm for a, bm, l, g, _ in pairs]),
        "lse_bwd_cols": (
            lambda: [ms.lse_bwd_cols(a, bm, l, g) for a, bm, l, g, _ in pairs],
            lambda: [ms.lse_bwd_cols_plain(a, bm, l, g, w)
                     for a, bm, l, g, w in pairs],
            lambda: [dense_w(a, bm, l, g).T @ a for a, bm, l, g, _ in pairs]),
    }
    out = {}
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
        out[name] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                         bound_ms=bound_ms, bound_by=bound_by)
        log(f"  {name}: kernel {ms_k:.3f} ms | plain {ms_p:.3f} ms | dense "
            f"torch {ms_l:.3f} ms | bound {bound_ms:.4f} ms ({bound_by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) per step's "
            f"pair of launches, B={b} Bg={bg} K={k} D={d}")
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
    table (E-matrix, and the gradient under a random cotangent).  Returns
    the worst error of each kernel."""
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    cases = [(label, b, n, m, f, 0) for label, b, n, m, f in SDTW_PRESETS]
    cases += SDTW_EXTRA
    worst = {name: 0.0 for name in sd.LAUNCHES}
    seed = 0
    for label, b, n, m, feat, band in cases:
        for gamma in (0.1, 1e-5):
            seed += 1
            D = _sdtw_case(b, n, m, feat, gamma, seed)
            g = torch.randn(b, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed))
            val_k, r_k = sd.softdtw_fwd(D, gamma, band)
            val_p, r_p = sd.softdtw_fwd_plain(D, gamma, band)
            e_k = sd.softdtw_bwd(r_p, gamma, band)
            e_p = sd.softdtw_bwd_plain(r_p, gamma, band)
            torch.cuda.synchronize()
            checks = [("softdtw_fwd", "value", _err(val_k, val_p)),
                      ("softdtw_fwd", "R", _table_err(r_k, r_p)),
                      ("softdtw_bwd", "E", _err(e_k, e_p)),
                      ("softdtw_bwd", "grad_D", _err(
                          g[:, None, None] * sd.grad_from_e(e_k, n, m),
                          g[:, None, None] * sd.grad_from_e(e_p, n, m)))]
            finite = all(bool(torch.isfinite(x).all())
                         for x in (val_k, e_k))
            line = []
            for kern, what, (err, lim) in checks:
                worst[kern] = max(worst[kern], err)
                line.append(f"{what} {err:.2e}/{lim:.2e}")
                if err > lim or not finite:
                    raise AssertionError(
                        f"{label} gamma={gamma}: {kern} {what} disagrees with "
                        f"its plain version ({err} > {lim}, finite={finite})")
            log(f"  [{label} B={b} N={n} M={m} band={band} gamma={gamma}] "
                f"err/limit: {', '.join(line)} ok")
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


def _device_ms(fn, key, reps=20):
    """Mean device time of the kernels whose name holds ``key`` per call
    of ``fn``, from torch.profiler: the kernel alone, without the host
    time of its wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and key in e.key)
    return total / 1e3 / reps


def phase_softdtw_timing():
    """Both soft-DTW kernels and their plain versions at the four presets
    and at a full-width training shape (gamma 0.1), beside the bound of
    what the function needs, not of what the kernels move: bytes (forward:
    read D, write the dense (N+1) x (M+1) table R that the backward
    needs; backward: read that R, write grad_D) at the HBM rate, and
    special-function operations (forward 3 exp + 1 log per cell; backward
    the 3 exp of a cell's Cuturi-Blondel weights) at the SFU rate; the
    larger wins.  Returns the first preset's numbers."""
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    sfu, mhz, sms = _sfu_rate()
    log(f"  SFU rate {sfu / 1e12:.3f} T/s ({H100_SFU_PER_CLOCK_SM}/clk/SM x "
        f"{sms} SMs x {mhz:.0f} MHz)")
    out = {}
    for label, b, n, m, feat in SDTW_PRESETS + [SDTW_TRAIN_TIMED]:
        D = _sdtw_case(b, n, m, feat, 0.1, 7)
        _, r = sd.softdtw_fwd(D, 0.1)
        cells = b * n * m
        d_bytes = 4 * cells                 # D, and grad_D of its shape
        r_bytes = 4 * b * (n + 1) * (m + 1)
        work = {"softdtw_fwd": (d_bytes + r_bytes, 4 * cells,
                                lambda: sd.softdtw_fwd(D, 0.1),
                                lambda: sd.softdtw_fwd_plain(D, 0.1)),
                "softdtw_bwd": (r_bytes + d_bytes, 3 * cells,
                                lambda: sd.softdtw_bwd(r, 0.1),
                                lambda: sd.softdtw_bwd_plain(r, 0.1))}
        for name, (nbytes, ops, kern, plain) in work.items():
            t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / sfu
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            ms_k, ms_p = _time_ms(kern), _time_ms(plain)
            dev = _device_ms(kern, f"{name}_kernel")
            log(f"  {name} {label}: kernel {ms_k:.4f} ms per call, "
                f"{dev:.4f} ms on the device | plain {ms_p:.3f} "
                f"ms | bound {bound_ms:.5f} ms ({bound_by}: "
                f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} M SFU ops) | "
                f"{n + m - 1} dependent diagonal steps")
            if name not in out:
                out[name] = dict(ms=ms_k, plain_ms=ms_p, library_ms=None,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 device_ms=dev, shape=[b, n, m, feat])
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


def _train_full(loss_name, edit, counters, per_step):
    """``run_training`` at full width with the loss ``edit`` applies,
    TRAIN_STEPS steps at batch TRAIN_BATCH, every launch counter reset just
    before and read just after.  Each kernel in ``per_step`` must have
    launched that many times per step.  Returns (result, config, the
    launches of the run)."""
    from milnce_tpu_torch.config import full_preset
    from milnce_tpu_torch.train.loop import run_training

    cfg = full_preset()
    cfg.parallel.platform = "cuda"
    cfg.data.synthetic = True
    cfg.data.synthetic_num_samples = TRAIN_BATCH * TRAIN_STEPS
    cfg.train.batch_size = TRAIN_BATCH
    cfg.train.max_steps = TRAIN_STEPS
    cfg.train.n_display = 1
    cfg.loss.name = loss_name
    edit(cfg.loss)
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

    def edit(loss):
        loss.milnce_impl, loss.milnce_backend = "chunked", "cuda"
        loss.milnce_chunk = TRAIN_CHUNK

    res, cfg, launches = _train_full("milnce", edit, (ms, sd),
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

    def edit(loss):
        loss.sdtw_backend = "cuda"

    res, cfg, launches = _train_full("sdtw_3", edit, (ms, sd),
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
