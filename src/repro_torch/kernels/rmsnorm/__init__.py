from repro_torch.kernels.rmsnorm.ops import rms_norm  # noqa: F401
