"""The port's LM serving path as a trace shows it: the spans that
``launch.serve.generate`` opens, and the device time inside them."""

from __future__ import annotations

from typing import Callable, Optional

from portbench import tracing

# ``lm.prefill_step`` over the prompt batch, and the loop of
# ``lm.decode_step``, each closed after its synchronise.
PREFILL, DECODE = "repro_torch.lm.prefill", "repro_torch.lm.decode"


def device_us(trace: tracing.Trace, span: str,
              keep: Callable[[str], bool] = lambda name: True
              ) -> Optional[float]:
    """Microseconds in which a device op that ``keep`` takes ran inside
    the host spans named ``span`` (the union of the ops' intervals, cut
    to the spans); None where the trace has no such span or no such op
    inside one.  Device times come from the card's own clock, so the
    profiler's cost on the host, which stretches a host-bound loop,
    leaves them as an untraced run has them."""
    spans = tracing.merged(iv for iv in trace.host if iv[0] == span)
    inside = []
    for name, a, b in trace.device:
        if not keep(name):
            continue
        for s, e in spans:
            if a < e and b > s:
                inside.append((name, max(a, s), min(b, e)))
    return tracing.union_us(inside) if inside else None


def count(name: str) -> Optional[int]:
    """The program's counter ``name`` over the traced window, or None
    where the program keeps no such counter."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.counts().get(name)
