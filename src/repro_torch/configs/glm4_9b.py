"""glm4-9b [dense]: extreme GQA (2 KV heads vs 32 Q heads).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
[hf:THUDM/glm-4-9b; hf].  The kv=2 < TP=16 case is the interesting sharding
cell: Q heads shard 2-per-device while KV heads must be replicated 8-way
(GSPMD inserts the all-gather); see EXPERIMENTS.md.
"""

from repro_torch.configs.base import DENSE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_head=128,
        d_ff=13696,
        vocab=151552,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=5_000_000.0,
        pattern=DENSE_PATTERN,
        source="[hf:THUDM/glm-4-9b; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke",
        family="dense",
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
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
