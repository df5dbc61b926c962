"""PyTorch/CUDA port of milnce_tpu: the MIL-NCE trainer for an NVIDIA H100.

Imports torch only, never jax or the JAX package.  Layout and module names
follow ``milnce_tpu/`` so each module has a findable counterpart."""
