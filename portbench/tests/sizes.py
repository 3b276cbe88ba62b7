"""The cells' configurations cut to a size the host runs in seconds."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def small_config(name: str) -> dict:
    from portbench import spec

    cfg = spec.config(spec.benchmark(), name)
    if cfg["algorithm"] == "kmeans":
        return dict(cfg, points=8 * 512, iterations=10,
                    data=dict(cfg["data"], points_per_cluster=512))
    # under 4,095 points, so even a fault that leaves every core point a
    # cluster of its own stays inside the int16 state word; at 256 points
    # a cluster many degrees lie near min_pts
    return dict(cfg, points=8 * 256,
                data=dict(cfg["data"], points_per_cluster=256))
