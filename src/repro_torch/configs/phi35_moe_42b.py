"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2.

32L d_model=4096 32H (GQA kv=8) d_ff_expert=6400 vocab=32064, MoE 16e top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].
"""

from repro_torch.configs.base import MOE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=0,
        vocab=32064,
        norm="layernorm",
        act="swiglu",
        n_experts=16,
        top_k=2,
        d_ff_expert=6400,
        pattern=MOE_PATTERN,
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=0,
        vocab=512,
        norm="layernorm",
        act="swiglu",
        n_experts=4,
        top_k=2,
        d_ff_expert=32,
        pattern=MOE_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
