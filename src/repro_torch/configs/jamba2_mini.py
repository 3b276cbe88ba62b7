"""jamba2-mini [hybrid]: AI21-Jamba2-Mini, one period of its 32 layers.

Published (huggingface.co/ai21labs/AI21-Jamba2-Mini, config.json;
``model_type`` jamba): 32 layers, hidden 4,096, vocabulary 65,536, an
untied head, RMSNorm eps 1e-6; attention at one layer in 8 (offset 4),
GQA 32 query heads on 8 KV heads of 128, with no position embedding;
Mamba-1 elsewhere (d_inner 8,192, d_state 16, dt_rank 256, conv 4 with a
bias, no projection bias) with RMSNorms on dt, B and C; MoE every other
layer (offset 1), 16 experts, top-2 of a softmax over all 16, the weights
not renormalised, dropless; SwiGLU of width 14,336 in the experts and in
the dense FFNs.

Here ``n_layers`` is 8, one whole period (``JAMBA_PATTERN``, the
published layout): the whole model is four periods, about 52 B
parameters, as four pipeline stages, one a card.  Every width is as
published.  Differs from ``jamba-v0.1-52b``, which keeps the reference's
forms, in the four :class:`PortConfig` switches.
"""

from repro_torch.configs.base import JAMBA_PATTERN, PortConfig

_PUBLISHED = dict(
    family="hybrid",
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    top_k=2,
    ssm_conv=4,
    ssm_expand=2,
    pattern=JAMBA_PATTERN,
    rope=False,
    ssm_norms=True,
    router_renorm=False,
    moe_dropless=True,
)


def config() -> PortConfig:
    return PortConfig(
        name="jamba2-mini",
        n_layers=8,   # one period of the published 32
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=65536,
        n_experts=16,
        d_ff_expert=14336,
        ssm_state=16,
        dt_rank=256,
        source="[hf: ai21labs/AI21-Jamba2-Mini config.json]",
        **_PUBLISHED,
    )


def smoke() -> PortConfig:
    return PortConfig(
        name="jamba2-mini-smoke",
        n_layers=8,   # one full period
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        n_experts=4,
        d_ff_expert=128,
        ssm_state=4,
        dt_rank=8,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
        **_PUBLISHED,
    )
