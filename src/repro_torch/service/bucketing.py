"""Batch-shape bucket policies: how much a request's point count is padded.

Every batch with the same compatibility key *and* padded point count reuses
one prepared step — the service amortises per-shape setup (the paper's
dominant GPU "setup time", Fig. 6) across requests.  The bucket policy
decides the tradeoff behind that reuse:

- coarse buckets (few distinct padded shapes) maximise executable reuse
  and minimise recompiles, but skewed tenant workloads pay large padding
  waste — wasted compute *and* wasted joules, since energy is runtime
  times a roughly constant power draw (Fig. 9);
- fine buckets minimise padding but fragment the executable cache: every
  new shape is a fresh cache entry and warm-up, the setup overhead
  the paper shows burying small workloads.

Three policies span that spectrum (see ``docs/bucketing_study.md`` for
the measured comparison and the default recommendation):

``pow2``
    Next power of two.  Unbounded workloads compile at most
    O(log(max_n)) executables; worst-case padding approaches 50% per
    request, ~33% expected under in-bucket-uniform sizes.
``linear(step)``
    Round up to a multiple of ``step``.  Padding is bounded by
    ``step - 1`` points per request, but the executable-cache cardinality
    grows linearly with the size range.
``adaptive``
    Fits bucket edges to a decayed histogram of *observed* request
    shapes: an optimal weighted 1-D partition (dynamic program), re-fitted
    every ``refit_every`` observations.  Bucket-count selection is
    elbow-based — the smallest edge count whose waste is within
    ``elbow_tol`` of the best — so the executable cache stays as small as
    the traffic allows.  Every lookup is clamped at the ``pow2`` bucket
    (no request ever pads more than the fixed policy would, and the
    admission budget screen's :meth:`BucketPolicy.bucket_ceiling` stays
    valid across refits), and until the first fit (and for outliers
    beyond the largest fitted edge) it behaves exactly like ``pow2`` —
    a safe default: a cold service is indistinguishable from the old
    fixed-pow2 behaviour, and a fitted one is never worse per request.

All policies are thread-safe and idempotent (``bucket(bucket(n)) ==
bucket(n)``), and never return less than ``minimum`` — tiny requests
share one executable instead of compiling per size.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Sequence, Union

import numpy as np

DEFAULT_MINIMUM = 8
DEFAULT_LINEAR_STEP = 64
DEFAULT_MAX_BUCKETS = 8
DEFAULT_REFIT_EVERY = 64
DEFAULT_DECAY = 0.5
DEFAULT_ELBOW_TOL = 0.01
# distinct histogram sizes the adaptive fit will consider; beyond this the
# observation grid coarsens (sizes round up to a larger quantum) so the
# O(m^2 k) fit stays bounded no matter how diverse the traffic
DEFAULT_MAX_SIZES = 96
# fitted edges align up to this many points (hardware lanes like multiples
# of 8, and exact observed maxima would overfit one-off sizes)
EDGE_ALIGN = 8
# decayed weight below this fraction of the total is pruned at refit —
# how a drifted-away shape distribution actually leaves the histogram
PRUNE_FRACTION = 1e-3


def pow2_bucket(n: int, minimum: int = DEFAULT_MINIMUM) -> int:
    """Next power-of-two >= max(n, minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def _align_up(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


class BucketPolicy:
    """Maps a request's point count to the padded point count it runs at.

    ``bucket(n)`` must be >= n, >= ``minimum``, idempotent, and safe to
    call from any thread.  ``observe(n)`` feeds the policy one request
    shape (a no-op for static policies).  ``snapshot()`` is the JSON-able
    state that rides in ``metrics_snapshot()["bucketing"]["policy"]``.
    """

    name: str = "abstract"

    def bucket(self, n: int) -> int:
        raise NotImplementedError

    def observe(self, n: int) -> None:  # static policies ignore traffic
        return None

    def bucket_ceiling(self, n: int) -> int:
        """Upper bound on what :meth:`bucket` may EVER return for ``n``.

        For static policies this is ``bucket(n)`` itself; a self-tuning
        policy whose buckets move over time must bound them here.  The
        admission-time device-budget screen prices this ceiling, so a
        request admitted as in-budget can never later pad past what was
        screened (the bucket may shrink, never grow beyond the ceiling).
        """
        return self.bucket(n)

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name}


class Pow2Policy(BucketPolicy):
    """The original fixed policy: pad to the next power of two."""

    name = "pow2"

    def __init__(self, minimum: int = DEFAULT_MINIMUM) -> None:
        self.minimum = int(minimum)

    def bucket(self, n: int) -> int:
        return pow2_bucket(n, self.minimum)

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "minimum": self.minimum}


class LinearPolicy(BucketPolicy):
    """Pad to the next multiple of ``step``: bounded per-request waste
    (< ``step`` points), executable count linear in the size range."""

    def __init__(self, step: int = DEFAULT_LINEAR_STEP,
                 minimum: int = DEFAULT_MINIMUM) -> None:
        if step < 1:
            raise ValueError(f"linear bucket step must be >= 1, got {step}")
        self.step = int(step)
        self.minimum = int(minimum)
        self.name = f"linear:{self.step}"

    def bucket(self, n: int) -> int:
        return _align_up(max(int(n), self.minimum), self.step)

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "step": self.step,
                "minimum": self.minimum}


def _fit_edges(sizes: Sequence[int], weights: Sequence[float],
               max_buckets: int, elbow_tol: float,
               minimum: int = DEFAULT_MINIMUM) -> List[int]:
    """Optimal weighted 1-D bucketing: partition sorted ``sizes`` into
    contiguous groups, each padded to its maximum, minimising total
    weighted padding.  Returns the chosen group maxima.

    Two constraints shape the partition:

    - **at most** ``max(max_buckets, pow2 windows spanned)`` groups — the
      executable-cache budget (a histogram spanning w pow2 windows can
      never use fewer than w groups, see below, so the budget stretches
      to the feasible floor);
    - **no group spans a pow2 boundary** (``pow2(group min) >= group
      max``): :meth:`AdaptivePolicy.bucket` clamps every lookup at the
      pow2 ceiling the admission budget screen prices, and an edge a
      group member could not reach under that clamp would silently split
      the group into extra compiled shapes.  Constraining the fit keeps
      the clamp a no-op for every observed size.

    The DP is exact (O(m^2 k), inner loop vectorised — the refit runs on
    the dispatch thread, so it is kept to ~a millisecond at the default
    histogram budget); the returned edge count is the *smallest* k whose
    waste is within ``elbow_tol`` (fraction of total weighted points) of
    the best achievable — extra executables are only spent where they
    buy real padding back.
    """
    m = len(sizes)
    if m == 0:
        return []
    s = np.asarray(sizes, np.float64)
    w = np.asarray(weights, np.float64)
    p2 = np.asarray([pow2_bucket(int(x), minimum) for x in sizes],
                    np.float64)              # monotone with s
    # the pow2 partition itself (one group per pow2 window) always
    # satisfies the boundary constraint, so feasibility needs exactly the
    # number of windows the histogram spans
    k_feasible = len(set(p2.tolist()))
    k_max = min(max(max_buckets, k_feasible), m)
    wsum = np.concatenate(([0.0], np.cumsum(w)))          # prefix weights
    wssum = np.concatenate(([0.0], np.cumsum(w * s)))     # prefix weight*size
    total_points = float(wssum[m])

    # rows[g-1][j]: min waste covering the first j sizes with g groups,
    # where a group padding sizes[i..j-1] to sizes[j-1] costs
    # s[j-1] * (wsum[j] - wsum[i]) - (wssum[j] - wssum[i]),
    # allowed only when pow2(sizes[i]) >= sizes[j-1]
    prev = np.full(m + 1, np.inf)
    prev[0] = 0.0
    rows: List[np.ndarray] = []
    splits: List[np.ndarray] = []
    for g in range(1, k_max + 1):
        cur = np.full(m + 1, np.inf)
        ch = np.zeros(m + 1, np.int64)
        for j in range(g, m + 1):
            lo = max(g - 1, int(np.searchsorted(p2, s[j - 1], side="left")))
            if lo >= j:
                continue                     # no boundary-respecting split
            i = np.arange(lo, j)
            cand = (prev[i] + s[j - 1] * (wsum[j] - wsum[i])
                    - (wssum[j] - wssum[i]))
            a = int(np.argmin(cand))
            cur[j] = cand[a]
            ch[j] = i[a]
        rows.append(cur)
        splits.append(ch)
        prev = cur
    best_waste = float(rows[k_max - 1][m])
    budget = best_waste + elbow_tol * max(total_points, 1.0)
    k = next(g for g in range(1, k_max + 1) if rows[g - 1][m] <= budget)
    edges: List[int] = []
    j = m
    for g in range(k, 0, -1):
        edges.append(int(sizes[j - 1]))
        j = int(splits[g - 1][j])
    edges.reverse()
    return edges


class AdaptivePolicy(BucketPolicy):
    """Self-tuning buckets fitted to the observed request-shape histogram.

    ``observe`` feeds every drained request's point count into a
    histogram (sizes round up to an internal grid so the fit stays
    bounded); every ``refit_every`` observations the edges are re-fitted
    (see :func:`_fit_edges`) and the histogram decays by ``decay`` — old
    traffic fades, so a drifting shape distribution re-centres the edges
    within a few refit periods.  ``bucket`` falls back to ``pow2`` before
    the first fit and for outliers beyond the largest edge, and is
    *clamped* at the pow2 bucket everywhere — no request ever pads more
    than the fixed policy would, and the admission budget screen
    (:meth:`bucket_ceiling` = pow2) stays valid across refits.  Fitted
    edges never cross a pow2 boundary, so the clamp costs nothing on
    observed traffic; cardinality is bounded by ``max(max_buckets, pow2
    windows the histogram spans)`` + O(log(outlier range)).
    """

    name = "adaptive"

    def __init__(
        self,
        max_buckets: int = DEFAULT_MAX_BUCKETS,
        *,
        refit_every: int = DEFAULT_REFIT_EVERY,
        decay: float = DEFAULT_DECAY,
        elbow_tol: float = DEFAULT_ELBOW_TOL,
        minimum: int = DEFAULT_MINIMUM,
        max_sizes: int = DEFAULT_MAX_SIZES,
    ) -> None:
        if max_buckets < 1:
            raise ValueError(
                f"adaptive max_buckets must be >= 1, got {max_buckets}")
        self.max_buckets = int(max_buckets)
        self.refit_every = max(1, int(refit_every))
        self.decay = float(decay)
        self.elbow_tol = float(elbow_tol)
        self.minimum = int(minimum)
        self.max_sizes = max(2, int(max_sizes))
        self._lock = threading.Lock()
        self._hist: Dict[int, float] = {}     # grid size -> decayed weight
        self._grid = EDGE_ALIGN
        self._edges: List[int] = []
        self._since_fit = 0
        self.observed = 0
        self.refits = 0

    # -- observation ---------------------------------------------------------

    def observe(self, n: int) -> None:
        q = _align_up(max(int(n), self.minimum), self._grid)
        with self._lock:
            self._hist[q] = self._hist.get(q, 0.0) + 1.0
            self.observed += 1
            self._since_fit += 1
            due = self._since_fit >= self.refit_every
        if due:
            self.refit()

    def _coarsen_locked(self) -> None:
        """Double the observation grid until the histogram fits the fit
        budget; existing mass re-buckets upward (bucket(n) >= n holds)."""
        while len(self._hist) > self.max_sizes:
            self._grid *= 2
            merged: Dict[int, float] = {}
            for s, w in self._hist.items():
                q = _align_up(s, self._grid)
                merged[q] = merged.get(q, 0.0) + w
            self._hist = merged

    def refit(self) -> None:
        """Re-fit bucket edges to the current decayed histogram, then
        decay it.  Cheap no-op when nothing was observed."""
        with self._lock:
            self._since_fit = 0
            if not self._hist:
                return
            self._coarsen_locked()
            sizes = sorted(self._hist)
            weights = [self._hist[s] for s in sizes]
            edges = _fit_edges(sizes, weights, self.max_buckets,
                               self.elbow_tol, self.minimum)
            self._edges = [_align_up(e, EDGE_ALIGN) for e in edges]
            self.refits += 1
            # decay + prune: traffic that stopped arriving fades out of
            # the histogram (and eventually out of the edges)
            total = sum(weights) * self.decay
            floor = total * PRUNE_FRACTION
            self._hist = {s: w * self.decay for s, w in self._hist.items()
                          if w * self.decay >= floor}

    # -- lookup --------------------------------------------------------------

    def bucket(self, n: int) -> int:
        n_eff = max(int(n), self.minimum)
        p2 = pow2_bucket(n_eff, self.minimum)
        with self._lock:
            edges = self._edges
            if edges and n_eff <= edges[-1]:
                # clamp at the next power of two: a request far below its
                # covering edge (possible right after a re-fit moved the
                # edges under it) must never pad more than the fixed
                # policy would — "never worse than pow2" holds for every
                # single request, and the bucket can never exceed the
                # :meth:`bucket_ceiling` the admission budget screened
                return min(edges[bisect.bisect_left(edges, n_eff)], p2)
        # unfitted, or an outlier past the largest edge: the pow2 fallback
        # keeps cold-start behaviour identical to the fixed policy and
        # bounds outlier cardinality logarithmically
        return p2

    def bucket_ceiling(self, n: int) -> int:
        """The largest bucket any (past or future) fit may assign ``n``:
        the pow2 bucket, by the clamp in :meth:`bucket`."""
        return pow2_bucket(max(int(n), self.minimum), self.minimum)

    @property
    def fitted(self) -> bool:
        with self._lock:
            return bool(self._edges)

    def edges(self) -> List[int]:
        with self._lock:
            return list(self._edges)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "max_buckets": self.max_buckets,
                "refit_every": self.refit_every,
                "edges": list(self._edges),
                "refits": self.refits,
                "observed": self.observed,
                "grid": self._grid,
                "minimum": self.minimum,
            }


PolicySpec = Union[str, BucketPolicy, None]

_SPEC_HELP = (
    "valid bucket-policy specs: 'pow2', 'linear' or 'linear:<step>', "
    "'adaptive' or 'adaptive:<max_buckets>' or "
    "'adaptive:<max_buckets>:<refit_every>'"
)


def make_policy(spec: PolicySpec = None) -> BucketPolicy:
    """Build a policy from a CLI-style spec string (or pass one through).

    ``None`` and ``"pow2"`` give the original power-of-two policy;
    ``"linear:128"`` pads to multiples of 128; ``"adaptive"`` (optionally
    ``"adaptive:<max_buckets>[:<refit_every>]"``) self-tunes to traffic.
    """
    if spec is None:
        return Pow2Policy()
    if isinstance(spec, BucketPolicy):
        return spec
    parts = str(spec).strip().lower().split(":")
    kind, args = parts[0], parts[1:]
    try:
        if kind == "pow2" and not args:
            return Pow2Policy()
        if kind == "linear" and len(args) <= 1:
            return LinearPolicy(int(args[0]) if args
                                else DEFAULT_LINEAR_STEP)
        if kind == "adaptive" and len(args) <= 2:
            kwargs: Dict[str, Any] = {}
            if args:
                kwargs["max_buckets"] = int(args[0])
            if len(args) == 2:
                kwargs["refit_every"] = int(args[1])
            return AdaptivePolicy(**kwargs)
    except ValueError as e:
        raise ValueError(
            f"bad bucket-policy spec {spec!r}: {e}; {_SPEC_HELP}") from None
    raise ValueError(f"unknown bucket-policy spec {spec!r}; {_SPEC_HELP}")
