from repro_torch.kernels.neighbor.ops import epsilon_degree, expand_frontier

__all__ = ["epsilon_degree", "expand_frontier"]
