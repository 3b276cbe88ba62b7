"""olmoe-1b-7b [moe]: 64 experts, top-8, 1B active / 7B total.

16L d_model=2048 16H (kv=16) d_ff_expert=1024 vocab=50304, MoE 64e top-8
[arXiv:2409.02060; hf].  The (64e, top-8) point is why the MoE layer uses
sort-based dispatch (see models/moe.py): the dispatch-mask einsum is
O(T*E*C) and explodes exactly here.
"""

from repro_torch.configs.base import MOE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=0,
        vocab=50304,
        norm="rmsnorm",
        act="swiglu",
        n_experts=64,
        top_k=8,
        d_ff_expert=1024,
        pattern=MOE_PATTERN,
        source="[arXiv:2409.02060; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=0,
        vocab=512,
        norm="rmsnorm",
        act="swiglu",
        n_experts=8,
        top_k=2,
        d_ff_expert=32,
        pattern=MOE_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
