from repro_torch.models.lm import (
    DecodeCache,
    init_params,
    param_axes,
    forward,
    init_decode_cache,
    decode_step,
    prefill_step,
)

__all__ = [
    "DecodeCache",
    "init_params",
    "param_axes",
    "forward",
    "init_decode_cache",
    "decode_step",
    "prefill_step",
]
