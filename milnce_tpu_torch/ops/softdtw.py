"""Soft-DTW constants (port of part of ``milnce_tpu/ops/softdtw.py``).

Only the finite ``BIG`` sentinel is ported so far: the MIL-NCE stream
masks padded logits with ``-BIG``.  The soft-DTW recurrence, its losses
and kernels come with the DTW-loss slice of the port.
"""

# Finite stand-in for infinity: exp(-BIG - m) is exactly 0 in f32 and,
# unlike -inf, never produces inf - inf = nan in a max/rescale.
BIG = 1e30
