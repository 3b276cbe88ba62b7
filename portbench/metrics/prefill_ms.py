"""prefill_ms (ms): the device time of a prefill, a mean over the jobs:
the union of the device ops inside the program's ``repro_torch.lm.prefill``
spans (``lm.prefill_step`` over the prompt batch, up to the synchronise
after it; ``launch.serve.generate``), over the number of such spans.
Read from the card's clock, so the profiler's host cost leaves it as an
untraced run has it; the host's share of a prefill is in
``device_idle``."""

from portbench import serving


def read(ctx):
    us = serving.device_us(ctx.trace, serving.PREFILL)
    jobs = sum(name == serving.PREFILL for name, _, _ in ctx.trace.host)
    if us is None:
        return None
    return us / jobs / 1e3
