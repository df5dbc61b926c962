from milnce_tpu_torch.native.build import load_native_library, native_available  # noqa: F401
