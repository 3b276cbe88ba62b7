"""Work counts and the card's peaks: the yardstick of the roofline shares.

The counts follow the algorithm that the reference states, never what a
kernel does, so a kernel that skips work reads higher and the yardstick
stays where it is.  Peaks are NVIDIA's data sheet for the H100 SXM at its
700 W limit (dense rates, no sparsity).
"""

from __future__ import annotations

# TF32 on the tensor cores: the rate for float32 inputs (dense).
PEAK_TF32_FLOPS = 495e12
# HBM3 bandwidth.
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def search(n: int, k: int, d: int) -> tuple:
    """(operations, bytes) of one K-Means assignment over n points.

    operations = 2·n·k·d: a multiply and an add for each feature of each
    (point, centroid) pair.
    bytes = 4·(n·d + k·d + 2·n): the points and the centroids read once,
    each point's index and distance written once.
    """
    return 2 * n * k * d, F32 * (n * d + k * d + 2 * n)


def lloyd_step_flops(n: int, k: int, d: int) -> int:
    """Operations of one Lloyd step: the search, 2·n·k·d, and the sums of
    the update, n·d (each point added to its centroid once)."""
    return 2 * n * k * d + n * d


def degree(n: int, d: int) -> tuple:
    """(operations, bytes) of the eps-degree of n points, the brute force
    the paper's DBSCAN states.

    operations = 2·d·n·(n+1)/2: a subtract and a multiply-add for each
    feature of each unordered pair, the point with itself included.
    bytes = 4·(n·d + n): the points read once, the degrees written once.
    """
    return 2 * d * n * (n + 1) // 2, F32 * (n * d + n)


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the TF32 peak and bytes over the HBM bandwidth."""
    return max(ops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)
