"""moe_roofline (%): the prefills' expert products against the bf16 peak.

The routed work (``jamba_work.routed_prefill_flops``: 6 d f a (token,
choice) pair a MoE layer, from the program's ``lm.prefill_tokens``) at
989 TFLOP/s, over the time in which an expert kernel
(``jamba_work.EXPERT_KERNELS``) ran on the card inside the program's
``repro_torch.lm.prefill`` spans (the union of their intervals).  Each
expert holds about a thousand rows a layer there, so the products are
bound by compute, and only skipped work could read past 100%."""

from portbench import jamba_work, serving


def read(ctx):
    n = jamba_work.program_counts()
    us = serving.device_us(ctx.trace, serving.PREFILL,
                           jamba_work.is_expert_kernel)
    if n is None or us is None:
        return None
    flops = jamba_work.routed_prefill_flops(ctx.config, n[0])
    return 100.0 * flops / (us / 1e6 * jamba_work.PEAK_BF16_FLOPS)
