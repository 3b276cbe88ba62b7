"""Which of the port's kernels (by the name ``torch.profiler`` shows for
them) belong to which layer: the tables the per-layer readers share.

A kernel's profiler name is its demangled signature; a table entry
matches it as a whole word (``tracing.matching``).
"""

# The K-Means search (csrc/distance.cu, csrc/fused.cu through
# csrc/assign_common.cuh): the centroid packing every call launches first,
# and the search in its staged, wide and exact forms.  The staged fused
# step (fused_partials_kernel, rows up to 96 features) sums in the same
# kernel; at wider rows the sums are wide_sums_kernel's, outside the
# search.
SEARCH = ("pack_centroids", "assign_kernel", "search_wide_kernel",
          "exact_wide_kernel", "fused_partials_kernel")

# The DBSCAN kernels (csrc/neighbor.cu).  Every call first packs the
# points (pack_points); the degree then runs degree_tri_kernel (d <= 9)
# or neighbor_kernel, an expansion gather_frontier and neighbor_kernel.
NEIGHBOR_LEAD = "pack_points"
DEGREE = ("degree_tri_kernel",)
EXPAND = ("gather_frontier", "neighbor_kernel")
