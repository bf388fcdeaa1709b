from repro_torch.kernels.permanova_sw.ops import permanova_sw  # noqa: F401
