"""launch_us (us): the mean host duration of the traced window's kernel
wrapper spans (``repro_torch.kernels.<wrapper>``): a launch's checks,
plan, allocations and ctypes call, on the profiler's clock."""

PREFIX = "repro_torch.kernels."


def read(ctx):
    spans = [b - a for name, a, b in ctx.trace.host
             if name.startswith(PREFIX)]
    if not spans or not ctx.trace.device:
        return None
    return sum(spans) / len(spans)
