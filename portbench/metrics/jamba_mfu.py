"""jamba_mfu (%): the whole serving job's share of the card's bf16 peak:
the window's model work (``jamba_work.job_flops`` of the program's
counters ``lm.prefill_tokens``, ``lm.decode_tokens`` and
``moe.routed_pairs``) over the traced window at 989 TFLOP/s.  None where
the program keeps no such counters or nothing ran on a card."""

from portbench import jamba_work


def read(ctx):
    n = jamba_work.program_counts()
    if n is None or not ctx.trace.device:
        return None
    flops = jamba_work.job_flops(ctx.config, *n)
    return 100.0 * flops / (ctx.trace.window_s * jamba_work.PEAK_BF16_FLOPS)
