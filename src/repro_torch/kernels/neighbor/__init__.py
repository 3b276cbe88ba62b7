from repro_torch.kernels.neighbor.ops import (
    epsilon_degree,
    epsilon_degree_cross,
    expand_frontier,
    expand_frontier_cross,
)

__all__ = ["epsilon_degree", "epsilon_degree_cross", "expand_frontier",
           "expand_frontier_cross"]
