"""internvl2-26b [vlm]: InternLM2-20B-style backbone behind InternViT.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf].  The ViT frontend is a stub: input_specs provides
precomputed patch embeddings (256 patches -> d_model), per the assignment.
"""

from repro_torch.configs.base import DENSE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab=92553,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=1_000_000.0,
        pattern=DENSE_PATTERN,
        frontend="vlm",
        prefix_len=256,
        source="[arXiv:2404.16821; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=512,
        norm="rmsnorm",
        act="swiglu",
        pattern=DENSE_PATTERN,
        frontend="vlm",
        prefix_len=8,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
