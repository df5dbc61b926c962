"""The bf16 tolerances of the port's parity tests (not a test module).

Two bf16 computations of the same function round at other places (XLA
fuses and reorders; PyTorch's CPU kernels round each op), so they agree
bit for bit only mostly.  Each bf16 result of the port is held to the
JAX package's bf16 result and to an f32/f64 result of the same function
(the reference):

- :func:`assert_bf16_close`, for a quantity bf16 computes to a few
  roundings (embeddings, losses, BatchNorm statistics): within ``ulps``
  bf16 unit roundoffs (2^-8) of the largest magnitude of JAX's result,
  element by element, and no farther from the reference in norm than
  ``NORM_FACTOR`` times JAX's (plus a floor of ``FLOOR`` unit roundoffs
  of the reference's norm, for a quantity JAX's run gets nearly exact).
- :func:`assert_bf16_group`, for a group of tensors bf16 computes only to
  its noise (parameter gradients through BatchNorm at a tiny batch carry
  10-30 % of their norm in bf16 noise, in both frameworks alike, and
  Adam turns that noise into lr-sized steps): over the whole group, the
  port's distance from the reference between ``1 / NORM_FACTOR`` and
  ``NORM_FACTOR`` times JAX's (the port is as accurate as JAX, and does
  round in bf16: a tower left in f32 would land far below); and each
  tensor within ``TENSOR_FACTOR`` times JAX's distance, a check that no
  one tensor has gone wrong (a few-element tensor's ratio of two noise
  norms spreads wide: up to 2.7 measured at this size).
"""

import numpy as np

BF16_EPS = 2.0 ** -8            # bf16's unit roundoff
NORM_FACTOR = 2.0
TENSOR_FACTOR = 4.0
FLOOR = 0.01


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp of each element of ``x``: 2^(floor(log2 |x|) - 7),
    that of the smallest normal at 0."""
    x = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


def as64(x) -> np.ndarray:
    """A torch tensor, a JAX array or a numpy array (bf16 included) as
    float64."""
    if hasattr(x, "detach"):
        return x.detach().double().numpy()
    return np.asarray(np.asarray(x).astype(np.float32), np.float64)


def _dist(a, ref) -> float:
    return float(np.linalg.norm(a - ref))


def assert_bf16_close(port, jax_bf16, ref, ulps: float, name: str = ""):
    port, jx, ref = as64(port), as64(jax_bf16), as64(ref)
    assert port.shape == jx.shape == ref.shape, (name, port.shape, jx.shape)
    assert np.isfinite(port).all(), name
    d_port, d_jax = _dist(port, ref), _dist(jx, ref)
    floor = FLOOR * BF16_EPS * np.linalg.norm(ref)
    assert d_port <= NORM_FACTOR * d_jax + floor, (
        f"{name}: the port's bf16 result is {d_port:.3e} from the reference, "
        f"JAX's {d_jax:.3e} (limit {NORM_FACTOR} x + {floor:.3e})")
    err = np.abs(port - jx).max(initial=0.0)
    lim = ulps * BF16_EPS * np.abs(jx).max(initial=0.0)
    assert err <= lim, (f"{name}: |port - jax| {err:.3e} above {ulps} bf16 "
                        f"unit roundoffs of max|jax| ({lim:.3e})")


def assert_bf16_group(port: dict, jax_bf16: dict, ref: dict, name: str):
    assert set(port) == set(ref) and set(port) <= set(jax_bf16) and port
    d_port = d_jax = 0.0
    for key in port:
        p, jx, r = as64(port[key]), as64(jax_bf16[key]), as64(ref[key])
        assert p.shape == jx.shape == r.shape, (key, p.shape, jx.shape)
        assert np.isfinite(p).all(), key
        dp, dj = _dist(p, r), _dist(jx, r)
        floor = FLOOR * BF16_EPS * np.linalg.norm(r)
        assert dp <= TENSOR_FACTOR * dj + floor, (
            f"{name} {key}: {dp:.3e} from the reference, JAX {dj:.3e}")
        d_port, d_jax = d_port + dp * dp, d_jax + dj * dj
    ratio = (d_port / d_jax) ** 0.5 if d_jax else 0.0
    assert 1 / NORM_FACTOR <= ratio <= NORM_FACTOR, (
        f"{name}: the port's distance from the reference is {ratio:.3f} x "
        "JAX's over the group")
