"""Edge-tier quantization (port of ``milnce_tpu/quant/``).

- :mod:`milnce_tpu_torch.quant.quantize` — weight-only symmetric int8
  post-training quantization on the Flax layout and keys (bit for bit
  the JAX package's) and the ``QuantizedModel`` module the serving
  engine runs with int8 resident.
- :mod:`milnce_tpu_torch.quant.calibrate` — the calibration pass:
  activation ranges, embedding-space quality against the f32 teacher,
  and the NUMERICS.md verdict reader that seeds the per-channel keys.
- :mod:`milnce_tpu_torch.quant.distill` — the distilled student text
  tower (frozen word table, thinner hidden layer), grafted back into a
  full-model variables tree so it exports and serves as any v1 artifact.
"""

from milnce_tpu_torch.quant.quantize import (  # noqa: F401
    OUTLIER_FRACTION, PER_CHANNEL_RATIO, QUANT_SCHEME, QuantizedModel,
    dequantize_array, dequantize_params, quantize_array,
    quantize_variables, weight_readiness_row)
