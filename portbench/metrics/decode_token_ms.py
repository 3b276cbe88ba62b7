"""decode_token_ms (ms): the device time of a decode step: the union of
the device ops inside the program's ``repro_torch.lm.decode`` spans (a
job's loop of ``lm.decode_step``, up to its synchronise) over the
window's decode steps, a step a token of each prompt (the program's
``lm.decode_tokens`` over the batch).  Read from the card's clock: the
decode is bound by the host, whose time a profiler stretches by its cost
an op, so the host's span would measure the profiler; the host's share
of a step is in ``device_idle`` and ``job_s``."""

from portbench import serving


def read(ctx):
    us = serving.device_us(ctx.trace, serving.DECODE)
    tokens = serving.count("lm.decode_tokens")
    if us is None or not tokens:
        return None
    return us / (tokens / ctx.config["batch"]) / 1e3
