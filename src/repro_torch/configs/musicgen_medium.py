"""musicgen-medium [audio]: decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec frontend is a stub: input_specs supplies precomputed
conditioning frame embeddings (prefix_len=64); the backbone decodes
EnCodec codebook tokens (vocab 2048).  MusicGen uses a vanilla transformer
(LayerNorm + GELU), not a llama-style block.
"""

from repro_torch.configs.base import DENSE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_head=64,
        d_ff=6144,
        vocab=2048,
        norm="layernorm",
        act="gelu",
        pattern=DENSE_PATTERN,
        frontend="audio",
        prefix_len=64,
        source="[arXiv:2306.05284; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_head=12,
        d_ff=96,
        vocab=256,
        norm="layernorm",
        act="gelu",
        pattern=DENSE_PATTERN,
        frontend="audio",
        prefix_len=4,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
