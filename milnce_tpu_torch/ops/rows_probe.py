"""Where the time of the ``rows::`` kernel family goes, in each of its
modes (``lse_fwd``, ``lse_bwd_rows`` and ``lse_bwd_cols``), on one CUDA
card: ``python -m milnce_tpu_torch.ops.rows_probe``.

Builds ``csrc/milnce_stream.cu`` as it ships, and four times more with
``ROWS_SKIP`` set, each leaving out part of the kernel's work; all five
``nvcc`` at once.  It times each build's launch in each mode, per call
(median of 20 after warm-up, CUDA events, the wrapper's host work and
its combination of the partials included) and the kernel alone on the
device (torch.profiler, mean of 20), at the two launches of a training
step at the recipe shape, A (128, 512) against B (40960, 512) and
A (640, 512) against B (8192, 512), and at the same two at D = 1024, the
deep recipe, where every mode runs its cluster path (its plan, with
the clusters the card keeps resident, is printed); there the forward's
full build is also timed on its slab path.  The bits: 1 leaves
out the logits FMAs, 2 the gradient FMAs in the backward and the running
(max, sum) update in the forward, 4 the copies of the streamed operand
(B in ``lse_fwd`` and ``lse_bwd_rows``, A in ``lse_bwd_cols``); 3 leaves
out both, so that copies are all that is left.  For the forward the
five builds read: full, without the logits FMAs, without the (max, sum)
update, without the copies of B, copies only (bit 2 puts a plain sum of
the logits in the update's place, so that their FMAs stay live).  The
full forward is also timed with every kernel of its call on the device
(the kernel and the combination of its partials), beside the library
call ``torch.logsumexp(a @ b.T, 1)``, every kernel of it too.  The
partial builds compute wrong values; only the full one is checked,
against ``lse_plain``, ``lse_bwd_rows_plain`` and
``lse_bwd_cols_plain``.

``--dtype bf16`` times the bf16 mode instead: B (the gathered operand)
in bf16, each kernel on its bf16 instances, the five builds as above
and the f32 mode's full build beside them on ``B.float()``; the full
bf16 build is checked equal, bit for bit, to the f32 mode on
``B.float()`` (``lse_bwd_cols``'s dB: the f32 mode's rounded to bf16).

``--accuracy`` instead prints the clusters of 1 to 8 blocks the card
keeps resident, for each kernel's cluster path, and the deep forward's and backward's error against float64 on
both paths (the cluster path and the slab path, the backward given the
same path's lse; the cluster path also with its weights divided by
their row sum, as the stream's backward runs it; and the plain version
given ``lse_plain``'s) at the card tests' deep shapes (the slab path
alone past the cluster path's reach, at D = 4608), with unit-normal
inputs and with inputs scaled to unit-scale logits.  Exits non-zero,
printing nothing, without a card.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from milnce_tpu_torch.ops import milnce_stream as ms
from milnce_tpu_torch.utils.timing import event_ms

VARIANTS = {"full": (), "skip 1": ("ROWS_SKIP=1",), "skip 2": ("ROWS_SKIP=2",),
            "skip 4": ("ROWS_SKIP=4",), "skip 3": ("ROWS_SKIP=3",)}
LABELS = {"lse_fwd": ("full", "no logits FMAs", "no (max, sum) update",
                      "no copies", "copies only"),
          "lse_bwd": ("full", "no logits FMAs", "no grad FMAs", "no copies",
                      "copies only")}
SHAPES = [(128, 40960, 512), (640, 8192, 512), (128, 40960, 1024),
          (640, 8192, 1024)]
F32_FLOPS = 67e12                  # one H100 SXM, f32 outside tensor cores


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median ms of a call on the card (``utils/timing.py::event_ms``)."""
    return event_ms(fn, reps=reps, warm=warm, device="cuda")


PAD_CYCLES = 20_000_000            # ~10 ms of a spinning kernel at 1.98 GHz


def _profiled(fn, calls: int, key: str) -> dict:
    """{name: (launches, device us)} of the CUDA kernels whose name holds
    ``key`` over ``calls`` calls of ``fn`` under one torch.profiler
    session.  A spinning kernel of ~10 ms stands before and after the
    calls, so that none falls near the session's edges, where the
    profiler can drop launches late in a long process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PAD_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    return {e.key: (e.count, getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0)))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key
            and "spin_kernel" not in e.key}


MAX_DROPPED = 2                    # launches a session may lose at its edges


def session_ms(got: dict, reps: int):
    """The device ms a call of one profiler session's ``got`` ({name:
    (launches, device us)} over ``reps`` calls), or None when the session
    does not count.  Each kernel's launches a call are its count over
    ``reps`` rounded, at least one; the session counts only if no kernel
    lost more than :data:`MAX_DROPPED` of them (the profiler on some
    cards drops a launch at a session's start, at random) and none has a
    launch more than ``reps`` times that (a stray launch would enter the
    mean).  A kernel's time a call is then the mean of its recorded
    launches times its launches a call, so a dropped launch cannot read
    as a faster call."""
    per_call = {k: max(1, round(n / reps)) for k, (n, _) in got.items()}
    if not got or not all(0 <= reps * per_call[k] - n <= MAX_DROPPED
                          for k, (n, _) in got.items()):
        return None
    return sum(us / n * per_call[k] for k, (n, us) in got.items()) / 1e3


def device_kernels(fn, key: str, reps: int = 20, log=print):
    """Mean device time (ms) per call of ``fn`` of the CUDA kernels whose
    name holds ``key`` (every kernel of the call with key ''), from
    torch.profiler, without the host time of its wrapper, and those
    kernels' names.  One session of ``reps`` calls, read by
    :func:`session_ms`; a session that does not count runs again, up to
    five times, and then it raises, as it does when no kernel matched (a
    renamed kernel cannot read as 0 ms)."""
    fn()
    torch.cuda.synchronize()
    for session in range(5):
        got = _profiled(fn, reps, key)
        t = session_ms(got, reps)
        if t is not None:
            return t, sorted(got)
        log(f"  (profiler session {session + 1}, kernels holding {key!r}: "
            f"{ {k: n for k, (n, _) in got.items()} } launches in {reps} "
            "calls; profiling again)")
    raise AssertionError(f"the profiler recorded no steady count of the "
                         f"CUDA kernels whose name holds {key!r} in five "
                         "sessions")


def _device_ms(fn, key: str, reps: int = 20) -> float:
    """The device time of :func:`device_kernels`."""
    return device_kernels(fn, key, reps)[0]


def _check(name, got, want) -> None:
    err = float((got - want).abs().max())
    lim = 1e-5 + 1e-4 * float(want.abs().max())
    if not err <= lim:
        raise AssertionError(f"{name}: full build disagrees: {err} > {lim}")


def _same(name, got, want) -> None:
    """The bf16 mode's output equals the f32 mode's on B widened."""
    if got.dtype != want.dtype or not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"{name}: the bf16 mode is not the f32 mode on "
                             f"B widened, bit for bit (max diff {err})")


def _line(label, fn, key, flops) -> str:
    t, dev = _time_ms(fn), _device_ms(fn, key)
    return (f"  {label:22s} {t:.4f} ms a call, {dev:.4f} ms on the device "
            f"({flops / dev / 1e9:.2f} TFLOP/s of the full launch's FLOPs, "
            f"{flops / F32_FLOPS * 1e3 / dev:.3f} of the f32 bound)")


# (B, Bg, K, D) of the card tests' deep cases
ACCURACY_SHAPES = [(4, 8, 3, 769), (33, 300, 3, 1000), (8, 64, 2, 2048),
                   (16, 64, 2, 4096), (4, 8, 3, 4608)]


def _backward_f64(a, b, g):
    """dA and dB of sum_r g_r logsumexp_j a_r . b_j in float64."""
    a, b, g = a.double(), b.double(), g.double()  # graftlint: disable=GL004(the float64 yardstick the kernels' f32 error is read against)
    x = a @ b.T
    w = torch.exp(x - torch.logsumexp(x, dim=1, keepdim=True)) * g[:, None]
    return w @ b, w.T @ a


def _err64(got, want) -> str:
    return f"{float((got.double() - want).abs().max()):.2e}"  # graftlint: disable=GL004(error against the float64 yardstick)


def accuracy() -> None:
    lib = ms._lib()
    for name in ("lse_fwd", "lse_bwd_rows", "lse_bwd_cols"):
        counts = [ms.card_clusters(lib, name, n, "cuda") for n in range(1, 9)]
        print(f"resident clusters of 1-8 blocks, {name}: {counts}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, bg, k, d in ACCURACY_SHAPES:
        for scale in (1.0, d ** -0.25):
            rng = np.random.default_rng(b + bg)
            v, t, v_all, t_all = (
                torch.tensor(rng.standard_normal((n, d), np.float32) * scale,
                             device="cuda") for n in (b, b * k, bg, bg * k))
            for a, bm in ((v, t_all), (t, v_all)):
                r, c = a.shape[0], bm.shape[0]
                g = torch.tensor(rng.standard_normal(r, np.float32),
                                 device="cuda")
                want = _backward_f64(a, bm, g)
                lse64 = torch.logsumexp(a.double() @ bm.double().T, dim=1)  # graftlint: disable=GL004(the float64 yardstick)
                got, fwd = {}, []
                paths = (("slab", True),) if d > ms.CLUSTER_REACH else (
                    ("cluster", False), ("slab", True))
                for path, slab in paths:
                    lse = ms.launch_fwd(lib, a, bm, _plan=ms.fwd_plan(
                        r, c, d, sms, slab=True) if slab else None)[0]
                    fwd.append(f"{path} {_err64(lse, lse64)}")
                    got[path] = []
                    for cols in (False, True):
                        plan = ((ms.cols_plan if cols else ms.rows_plan)(
                            r, c, d, sms, slab=True) if slab else None)
                        got[path].append(ms.launch_bwd(lib, a, bm, lse, g,
                                                       cols, _plan=plan)[0])
                    if slab:
                        continue
                    # the stream's use of the cluster path: the weights
                    # divided by their row sum
                    da, _, s = ms.launch_bwd(lib, a, bm, lse, g, False)
                    got["cluster renormalized"] = [
                        da / s[:, None],
                        ms.launch_bwd(lib, a, bm, lse, g / s, True)[0]]
                lse_p = ms.lse_plain(a, bm, 4096)
                fwd.append(f"plain {_err64(lse_p, lse64)}")
                got["plain"] = [ms.lse_bwd_rows_plain(a, bm, lse_p, g, 4096),
                                ms.lse_bwd_cols_plain(a, bm, lse_p, g, 4096)]
                errs = ", ".join(
                    f"{path} " + " ".join(
                        f"{float((x.double() - w).abs().max()):.2e}"  # graftlint: disable=GL004(error against the float64 yardstick)
                        for x, w in zip(outs, want))
                    for path, outs in got.items())
                limit = " ".join(f"{1e-5 + 1e-4 * float(w.abs().max()):.2e}"
                                 for w in want)
                print(f"B={b} Bg={bg} K={k} D={d} R={r} C={c} scale "
                      f"{scale:.3f} max|x| {float((a @ bm.T).abs().max()):.1f}"
                      f": error against float64, lse: {', '.join(fwd)}; "
                      f"(dA dB): {errs}; the card tests' limit {limit}")


def main() -> int:
    if not torch.cuda.is_available():
        print("rows_probe: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    if sys.argv[1:] == ["--accuracy"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        accuracy()
        return 0
    if sys.argv[1:] not in ([], ["--dtype", "bf16"]):
        print("usage: rows_probe [--accuracy | --dtype bf16]",
              file=sys.stderr)
        return 2
    bf16 = sys.argv[1:] == ["--dtype", "bf16"]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(ms._lib, VARIANTS.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r, c, d in SHAPES:
        a = torch.randn((r, d), generator=gen, device="cuda") * d ** -0.25
        b = torch.randn((c, d), generator=gen, device="cuda") * d ** -0.25
        b16 = b.to(torch.bfloat16) if bf16 else None
        if bf16:                  # the f32 mode on B widened: B's values
            b = b16.float()
        lse = torch.logsumexp(a @ b.T, dim=1)
        g = torch.full((r,), 1.0 / r, device="cuda")
        plan = ms.card_fwd_plan(libs[0], r, c, d, "cuda")
        parts = plan.parts or None
        _check("lse_fwd", ms.launch_fwd(libs[0], a, b)[0],
               ms.lse_plain(a, b, 4096, parts))
        print(f"lse_fwd R={r} C={c} D={d}: {plan}")
        flops = 2 * r * c * d
        if bf16:
            _same("lse_fwd", ms.launch_fwd(libs[0], a, b16)[0],
                  ms.launch_fwd(libs[0], a, b)[0])
            print(_line("f32 mode, full", lambda: ms.launch_fwd(libs[0], a, b),
                        "lse_fwd_kernel", flops))
        bt = b16 if bf16 else b   # the B each build is timed on
        for label, lib in zip(LABELS["lse_fwd"], libs):
            print(_line(label, lambda: ms.launch_fwd(lib, a, bt),
                        "lse_fwd_kernel", flops))
        print(_line("full, every kernel",
                    lambda: ms.launch_fwd(libs[0], a, bt), "", flops))
        if plan.mode == "deep":
            slab = ms.fwd_plan(r, c, d, sms, slab=True)
            _check("lse_fwd slab path", ms.launch_fwd(
                libs[0], a, b, _plan=slab)[0],
                ms.lse_plain(a, b, 4096, parts))
            if bf16:
                _same("lse_fwd slab path",
                      ms.launch_fwd(libs[0], a, b16, _plan=slab)[0],
                      ms.launch_fwd(libs[0], a, b, _plan=slab)[0])
            print(f"  slab path: {slab}")
            print(_line("slab path", lambda: ms.launch_fwd(
                libs[0], a, bt, _plan=slab), "lse_fwd_kernel", flops))
        print(_line("library call", lambda: torch.logsumexp(a @ b.T, 1), "",
                    flops))
        flops = 4 * r * c * d
        for name, cols, plain in (
                ("lse_bwd_rows", False, ms.lse_bwd_rows_plain),
                ("lse_bwd_cols", True, ms.lse_bwd_cols_plain)):
            _check(name, ms.launch_bwd(libs[0], a, b, lse, g, cols)[0],
                   plain(a, b, lse, g, 4096))
            print(f"{name} R={r} C={c} D={d}: "
                  f"{ms.card_bwd_plan(libs[0], cols, r, c, d, 'cuda')}")
            if bf16:
                _same(name, ms.launch_bwd(libs[0], a, b16, lse, g, cols)[0],
                      ms.launch_bwd(libs[0], a, b, lse, g, cols)[0].to(
                          torch.bfloat16 if cols else torch.float32))
                print(_line("f32 mode, full", lambda: ms.launch_bwd(
                    libs[0], a, b, lse, g, cols), "lse_bwd_kernel", flops))
            for label, lib in zip(LABELS["lse_bwd"], libs):
                print(_line(label,
                            lambda: ms.launch_bwd(lib, a, bt, lse, g, cols),
                            "lse_bwd_kernel", flops))
    return 0


if __name__ == "__main__":
    sys.exit(main())
