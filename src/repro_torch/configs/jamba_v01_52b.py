"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536
[arXiv:2403.19887; hf].  Period-8 pattern: one attention layer per 8
(position 4, as in the paper's figure), MoE every other layer; mamba mixer
elsewhere (d_inner=8192, state=16, dt_rank=256).  Runs long_500k: only 4
attention layers hold 500k KV; mamba layers are O(1)-state.
"""

from repro_torch.configs.base import JAMBA_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=65536,
        norm="rmsnorm",
        act="swiglu",
        n_experts=16,
        top_k=2,
        d_ff_expert=14336,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        dt_rank=256,
        pattern=JAMBA_PATTERN,
        source="[arXiv:2403.19887; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        family="hybrid",
        n_layers=8,   # one full period
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        norm="rmsnorm",
        act="swiglu",
        n_experts=4,
        top_k=2,
        d_ff_expert=64,
        ssm_state=4,
        ssm_conv=4,
        ssm_expand=2,
        dt_rank=8,
        pattern=JAMBA_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
