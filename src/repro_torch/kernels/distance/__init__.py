from repro_torch.kernels.distance.ops import assign_clusters, pairwise_sq_dists

__all__ = ["assign_clusters", "pairwise_sq_dists"]
