from repro_torch.data.synthetic import ClusterSpec, make_blobs, paper_grid

__all__ = ["ClusterSpec", "make_blobs", "paper_grid"]
