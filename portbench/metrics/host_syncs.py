"""host_syncs (count): the device-to-host reads of the solver loops a job,
the program's own counter (``repro_torch.runtime.spans``' ``host_syncs``:
each read that ``spans.read`` makes in the Lloyd and BFS loops), over
the traced window's jobs.  None where the program keeps no such counter
or nothing ran on a card."""


def host_syncs():
    """The program's count of the window's reads, or None where the
    program keeps no such counter."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.counts().get("host_syncs")


def read(ctx):
    n = host_syncs()
    if n is None or not ctx.jobs or not ctx.trace.device:
        return None
    return n / len(ctx.jobs)
