from repro_torch.kernels.attention.ops import flash_attention

__all__ = ["flash_attention"]
