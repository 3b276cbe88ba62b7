"""The cells' configurations cut to a size the host runs in seconds."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def small_config(name: str) -> dict:
    """Configuration ``name`` as its algorithm cuts it for the host
    (``small`` in ``portbench/checks/<algorithm>.py``)."""
    from portbench import spec

    cfg = spec.config(spec.benchmark(), name)
    return spec.comparison(cfg["algorithm"]).small(cfg)
