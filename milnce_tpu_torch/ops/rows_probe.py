"""Where the time of the ``rows::`` kernel family goes, in each of its
modes (``lse_fwd``, ``lse_bwd_rows`` and ``lse_bwd_cols``), on one CUDA
card: ``python -m milnce_tpu_torch.ops.rows_probe``.

Builds ``csrc/milnce_stream.cu`` as it ships, and four times more with
``ROWS_SKIP`` set, each leaving out part of the kernel's work; all five
``nvcc`` at once.  It times each build's launch in each
mode, per call (median of 20 after warm-up, CUDA events, the wrapper's
host work and its combination of the partials included) and the kernel
alone on the device (torch.profiler, mean of 20), at the two launches of
a training step at the recipe shape: A (128, 512) against B (40960, 512), and A (640, 512)
against B (8192, 512).  The bits: 1 leaves out the logits FMAs, 2 the
gradient FMAs in the backward and the running (max, sum) update in the
forward, 4 the copies of the streamed operand (B in ``lse_fwd`` and
``lse_bwd_rows``, A in ``lse_bwd_cols``); 3 leaves out both, so that
copies are all that is left.  For the forward the five builds read: full,
without the logits FMAs, without the (max, sum) update, without the
copies of B, copies only (bit 2 puts a plain sum of the logits in the
update's place, so that their FMAs stay live).  The full forward is also
timed with every kernel of its call on the device (the kernel and the
combination of its partials), beside the library call
``torch.logsumexp(a @ b.T, 1)``, every kernel of it too.  The partial builds
compute wrong values; only the full one is checked, against
``lse_plain``, ``lse_bwd_rows_plain`` and ``lse_bwd_cols_plain``.  Exits
non-zero, printing nothing, without a card.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from milnce_tpu_torch.ops import milnce_stream as ms

VARIANTS = {"full": (), "skip 1": ("ROWS_SKIP=1",), "skip 2": ("ROWS_SKIP=2",),
            "skip 4": ("ROWS_SKIP=4",), "skip 3": ("ROWS_SKIP=3",)}
LABELS = {"lse_fwd": ("full", "no logits FMAs", "no (max, sum) update",
                      "no copies", "copies only"),
          "lse_bwd": ("full", "no logits FMAs", "no grad FMAs", "no copies",
                      "copies only")}
SHAPES = [(128, 40960, 512), (640, 8192, 512)]
F32_FLOPS = 67e12                  # one H100 SXM, f32 outside tensor cores


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
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


def _device_ms(fn, key: str, reps: int = 20) -> float:
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``key``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key) / 1e3 / reps


def _check(name, got, want) -> None:
    err = float((got - want).abs().max())
    lim = 1e-5 + 1e-4 * float(want.abs().max())
    if not err <= lim:
        raise AssertionError(f"{name}: full build disagrees: {err} > {lim}")


def _line(label, fn, key, flops) -> str:
    t, dev = _time_ms(fn), _device_ms(fn, key)
    return (f"  {label:22s} {t:.4f} ms a call, {dev:.4f} ms on the device "
            f"({flops / dev / 1e9:.2f} TFLOP/s of the full launch's FLOPs, "
            f"{flops / F32_FLOPS * 1e3 / dev:.3f} of the f32 bound)")


def main() -> int:
    if not torch.cuda.is_available():
        print("rows_probe: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(ms._lib, VARIANTS.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r, c, d in SHAPES:
        a = torch.randn((r, d), generator=gen, device="cuda") * d ** -0.25
        b = torch.randn((c, d), generator=gen, device="cuda") * d ** -0.25
        lse = torch.logsumexp(a @ b.T, dim=1)
        g = torch.full((r,), 1.0 / r, device="cuda")
        _check("lse_fwd", ms.launch_fwd(libs[0], a, b)[0],
               ms.lse_plain(a, b, 4096))
        print(f"lse_fwd R={r} C={c} D={d}: {ms.fwd_plan(r, c, d, sms)}")
        flops = 2 * r * c * d
        for label, lib in zip(LABELS["lse_fwd"], libs):
            print(_line(label, lambda: ms.launch_fwd(lib, a, b),
                        "lse_fwd_kernel", flops))
        print(_line("full, every kernel", lambda: ms.launch_fwd(libs[0], a, b),
                    "", flops))
        print(_line("library call", lambda: torch.logsumexp(a @ b.T, 1), "",
                    flops))
        flops = 4 * r * c * d
        for name, cols, plain, plan_of in (
                ("lse_bwd_rows", False, ms.lse_bwd_rows_plain, ms.rows_plan),
                ("lse_bwd_cols", True, ms.lse_bwd_cols_plain, ms.cols_plan)):
            _check(name, ms.launch_bwd(libs[0], a, b, lse, g, cols)[0],
                   plain(a, b, lse, g, 4096))
            print(f"{name} R={r} C={c} D={d}: {plan_of(r, c, d, sms)}")
            for label, lib in zip(LABELS["lse_bwd"], libs):
                print(_line(label,
                            lambda: ms.launch_bwd(lib, a, b, lse, g, cols),
                            "lse_bwd_kernel", flops))
    return 0


if __name__ == "__main__":
    sys.exit(main())
