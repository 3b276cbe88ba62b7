"""olmo-1b [dense]: non-parametric LayerNorm, tied embeddings.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304 [arXiv:2402.00838; hf].
OLMo's LN has no learned affine (norm="nonparam_ln"); SwiGLU MLP with the
published d_ff=8192 total hidden.
"""

from repro_torch.configs.base import DENSE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=8192,
        vocab=50304,
        norm="nonparam_ln",
        act="swiglu",
        tie_embeddings=True,
        pattern=DENSE_PATTERN,
        source="[arXiv:2402.00838; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=512,
        norm="nonparam_ln",
        act="swiglu",
        tie_embeddings=True,
        pattern=DENSE_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
