"""``core.kmeans.fit_cancellable``: the one-job Lloyd solver that
``launch.mine.run_mining_job`` runs, from the benchmark's initial
centroids for a fixed number of steps (``tol`` 0)."""

from __future__ import annotations

import torch

from portbench import drive, inputs


class Entry(drive.Entry):

    def __init__(self, *args) -> None:
        super().__init__(*args)
        from repro_torch.core import kmeans
        from repro_torch.core.cancellation import CancellationToken
        self.kmeans, self.token = kmeans, CancellationToken
        self.cfg = kmeans.KMeansConfig(k=self.config["k"],
                                       max_iters=self.config["iterations"],
                                       tol=float(self.config["tol"]))

    def initial(self, j: int) -> torch.Tensor:
        return inputs.initial_centroids(self.data[self.dataset(j)],
                                        self.config["k"], self.seed, j)

    def run(self, j: int):
        return self.kmeans.fit_cancellable(
            j, self.data[self.dataset(j)], self.cfg, token=self.token(),
            centroids=self.initial(j))

    def fetch(self, result, keep: bool) -> dict:
        return {"labels": self.host("labels", result.labels, keep),
                "centroids": self.host("centroids", result.centroids, keep),
                "inertia": float(result.inertia)}

    def last_step(self, j: int, centroids: torch.Tensor) -> torch.Tensor:
        """The labels job j's last step gives from ``centroids``: the same
        call resumed at its last iteration (its ``start_iteration``)."""
        result = self.kmeans.fit_cancellable(
            j, self.data[self.dataset(j)], self.cfg, token=self.token(),
            centroids=centroids, start_iteration=self.cfg.max_iters - 1)
        return result.labels

    def counters(self, result) -> dict:
        from repro_torch.kernels.distance.ops import assign_clusters
        stats = assign_clusters.recheck_stats
        return {"iterations": int(result.iterations),
                "rechecks": None if stats is None else int(stats[0]),
                "recheck_rows": self.data[0].shape[0]}
