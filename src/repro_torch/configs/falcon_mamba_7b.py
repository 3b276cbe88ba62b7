"""falcon-mamba-7b [ssm]: attention-free Mamba-1.

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16
[arXiv:2410.05355; unverified].  d_inner = 2*d_model = 8192,
dt_rank = d_model/16 = 256, conv kernel 4 (mamba1 reference shapes).
Runs the long_500k cell: decode state is O(1) in sequence length.
"""

from repro_torch.configs.base import MAMBA_PATTERN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        vocab=65024,
        d_ff=0,
        norm="rmsnorm",
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        dt_rank=256,
        pattern=MAMBA_PATTERN,
        source="[arXiv:2410.05355; unverified]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        vocab=512,
        d_ff=0,
        norm="rmsnorm",
        ssm_state=4,
        ssm_conv=4,
        ssm_expand=2,
        dt_rank=8,
        pattern=MAMBA_PATTERN,
        dtype="float32",
        ssm_chunk=8,
        head_pad_multiple=4,
        source="smoke",
    )
