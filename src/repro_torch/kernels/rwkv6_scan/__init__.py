from repro_torch.kernels.rwkv6_scan.ops import wkv6  # noqa: F401
