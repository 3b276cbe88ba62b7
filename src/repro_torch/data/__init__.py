from repro_torch.data.synthetic import ClusterSpec, make_blobs, paper_grid
from repro_torch.data.tokens import (
    TokenBatch,
    step_generator,
    synthetic_token_batch,
    synthetic_token_batches,
)

__all__ = ["ClusterSpec", "make_blobs", "paper_grid", "TokenBatch",
           "step_generator", "synthetic_token_batch",
           "synthetic_token_batches"]
