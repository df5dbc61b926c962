"""Where the time of the backward kernel goes, in both of its modes
(``lse_bwd_rows`` and ``lse_bwd_cols``), on one CUDA card:
``python -m milnce_tpu_torch.ops.rows_probe``.

Builds ``csrc/milnce_stream.cu`` as it ships and four times more with
``ROWS_SKIP`` set, all five ``nvcc`` at once, each leaving out part of the
kernel's work (1: the logits FMAs, 2: the gradient FMAs, 4: the copies of
the streamed operand, 3: both products), and times each build's launch
(median of 20 after warm-up, CUDA events) in each mode at the two
launches of a training step at the recipe shape: A (128, 512) against B
(40960, 512), and A (640, 512) against B (8192, 512).  The partial builds
compute wrong values; only the full one is checked, against
``lse_bwd_rows_plain`` and ``lse_bwd_cols_plain``.  Exits non-zero,
printing nothing, without a card.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from milnce_tpu_torch.ops import milnce_stream as ms

VARIANTS = {"full": (), "no logits FMAs": ("ROWS_SKIP=1",),
            "no grad FMAs": ("ROWS_SKIP=2",), "no copies": ("ROWS_SKIP=4",),
            "copies only": ("ROWS_SKIP=3",)}
SHAPES = [(128, 40960, 512), (640, 8192, 512)]
MODES = {"lse_bwd_rows": (False, ms.lse_bwd_rows_plain, ms.rows_plan),
         "lse_bwd_cols": (True, ms.lse_bwd_cols_plain, ms.cols_plan)}
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
        libs = dict(zip(VARIANTS, pool.map(ms._lib, VARIANTS.values())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r, c, d in SHAPES:
        a = torch.randn((r, d), generator=gen, device="cuda") * d ** -0.25
        b = torch.randn((c, d), generator=gen, device="cuda") * d ** -0.25
        lse = torch.logsumexp(a @ b.T, dim=1)
        g = torch.full((r,), 1.0 / r, device="cuda")
        flops = 4 * r * c * d
        for name, (cols, plain, plan_of) in MODES.items():
            want = plain(a, b, lse, g, 4096)
            got = ms.launch_bwd(libs["full"], a, b, lse, g, cols)
            err = float((got - want).abs().max())
            lim = 1e-5 + 1e-4 * float(want.abs().max())
            if not err <= lim:
                raise AssertionError(f"{name}: full build disagrees: "
                                     f"{err} > {lim}")
            print(f"{name} R={r} C={c} D={d}: {plan_of(r, c, d, sms)}")
            for variant, lib in libs.items():
                t = _time_ms(lambda: ms.launch_bwd(lib, a, b, lse, g, cols))
                print(f"  {variant:15s} {t:.4f} ms  ({flops / t / 1e9:.2f} "
                      f"TFLOP/s of the full launch's FLOPs, "
                      f"{flops / F32_FLOPS * 1e3 / t:.3f} of the f32 bound)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
