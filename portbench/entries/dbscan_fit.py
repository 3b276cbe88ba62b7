"""``core.dbscan.fit_cancellable``: the one-job DBSCAN."""

from __future__ import annotations

import torch

from portbench import drive


class Entry(drive.Entry):

    def __init__(self, *args) -> None:
        super().__init__(*args)
        from repro_torch.core import dbscan
        from repro_torch.core.cancellation import CancellationToken
        self.dbscan, self.token = dbscan, CancellationToken
        self.cfg = dbscan.DBSCANConfig(eps=float(self.config["eps"]),
                                       min_pts=int(self.config["min_pts"]))

    def run(self, j: int):
        return self.dbscan.fit_cancellable(self.data[self.dataset(j)],
                                           self.cfg, token=self.token())

    def fetch(self, result, keep: bool) -> dict:
        return {"labels": self.host("labels", result.labels, keep),
                "core_mask": self.host("core_mask", result.core_mask, keep)}

    def degrees(self, i: int) -> torch.Tensor:
        """Dataset i's eps-degrees from the kernel every job's first call
        makes (``kernels.neighbor.ops.epsilon_degree``, as ``core.dbscan``
        calls it): the counts its core mask comes from."""
        from repro_torch.kernels.neighbor.ops import epsilon_degree
        return epsilon_degree(self.data[i], self.cfg.eps)

    def counters(self, result) -> dict:
        return {"expansions": int(result.expansions)}
