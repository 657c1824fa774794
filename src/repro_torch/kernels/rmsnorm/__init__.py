from repro_torch.kernels.rmsnorm.ops import add_rms_norm, rms_norm  # noqa: F401
