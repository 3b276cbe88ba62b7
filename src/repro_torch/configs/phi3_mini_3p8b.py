"""phi3-mini-3.8b [dense]: RoPE + SwiGLU + (degenerate) GQA.

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064 [arXiv:2404.14219;
unverified].
"""

from repro_torch.configs.base import DENSE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab=32064,
        norm="rmsnorm",
        act="swiglu",
        pattern=DENSE_PATTERN,
        source="[arXiv:2404.14219; unverified]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_head=12,
        d_ff=96,
        vocab=512,
        norm="rmsnorm",
        act="swiglu",
        pattern=DENSE_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
