from repro_torch.kernels.ssm.ops import selective_scan

__all__ = ["selective_scan"]
