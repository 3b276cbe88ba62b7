"""minicpm-2b [dense]: llama-like arch trained with the WSD schedule.

40L d_model=2304 36H (GQA kv=36, i.e. MHA) d_ff=5760 vocab=122753
[arXiv:2404.06395; hf].  The WSD (warmup-stable-decay) schedule the paper
introduces is implemented in repro.optim.schedule and selected by this
config's trainer defaults.
"""

from repro_torch.configs.base import DENSE_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_head=64,
        d_ff=5760,
        vocab=122753,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        pattern=DENSE_PATTERN,
        source="[arXiv:2404.06395; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=6,
        d_head=8,
        d_ff=96,
        vocab=512,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        pattern=DENSE_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
