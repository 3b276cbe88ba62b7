"""NaN input: the port's contract, pinned against the reference on the CPU.

Neither package checks points for finiteness when a request is admitted,
and the port keeps it so.  What the port promises instead:

- step 1's assignment of a NaN centroid or a NaN row equals the
  reference's oracle ``assign_clusters_ref`` (NaN ordered first, as
  ``argmin`` does), on every CPU route of the port: the K-Means step with
  and without the kernel wrappers, the assignment wrapper and the fused
  masked step;
- the one-job fit (``fit_cancellable``, what ``launch/mine.py`` runs) of
  128 points holding one NaN gives the reference's labels;
- ``fit`` stops at the NaN shift after one step, as the reference's
  ``while shift >= tol`` loop does.

The lanes split on the centroids, by design: the fused kernel (the
service's masked step) and the narrow-row sums (``fused.lloyd_sums``: the
one-job step and the mini-batch step on the card, for k <= 8 and d <= 4)
add a NaN row only to its own centroid's sums, where the plain version's
one-hot product spreads it to every centroid.  The one-job fit below
still ends on the reference's labels with the narrow-row sums' plain twin
routed in (the NaN centroid takes every row either way); its centroids
differ.  The split is pinned on the card
(``tests/test_torch_cuda.py::test_fused_kernel_keeps_a_nan_row_in_its_own_centroid``,
``::test_lloyd_sums_kernel_keeps_a_nan_row_in_its_own_centroid``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.kernels.distance.ref import assign_clusters_ref
from repro_torch.core import kmeans as tkm
from repro_torch.kernels.distance import fused as fops
from repro_torch.kernels.distance import ops as dops


def _inputs(where):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    c = rng.normal(size=(5, 4)).astype(np.float32)
    if where == "centroid":
        c[2, 1] = np.nan
    else:
        x[3, 0] = np.nan
    return x, c


@pytest.mark.parametrize("where", ["centroid", "row"])
def test_step_one_assignment_equals_the_oracle(where):
    x, c = _inputs(where)
    oracle = np.asarray(assign_clusters_ref(jnp.asarray(x),
                                            jnp.asarray(c))[0])
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    routes = {
        f"kmeans_step use_kernel={uk}": tkm.kmeans_step(
            xt, ct, tkm.KMeansConfig(k=5, use_kernel=uk))[0]
        for uk in (True, False)}
    routes["assign_clusters"] = dops.assign_clusters(xt, ct)[0]
    routes["fused_masked_assign_update"] = fops.fused_masked_assign_update(
        xt, ct, torch.ones(16, dtype=torch.bool))[0]
    for name, idx in routes.items():
        np.testing.assert_array_equal(idx.numpy(), oracle, err_msg=name)
    if where == "centroid":
        assert (oracle == 2).all()       # every row's NaN score wins
    else:
        assert oracle[3] == 0            # an all-NaN row takes index 0


@pytest.mark.parametrize("use_kernel", [True, False])
def test_one_job_fit_with_a_nan_point_gives_the_reference_labels(use_kernel):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, 2)).astype(np.float32)
    x[:64] += 6.0
    x[7, 0] = np.nan
    c0 = x[[0, 100]].copy()              # finite initial centroids
    kw = dict(k=2, max_iters=20, use_kernel=use_kernel)
    jr = jkm.fit_cancellable(None, jnp.asarray(x), jkm.KMeansConfig(**kw),
                             centroids=jnp.asarray(c0))
    tr = tkm.fit_cancellable(None, torch.from_numpy(x),
                             tkm.KMeansConfig(**kw),
                             centroids=torch.from_numpy(c0))
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    assert int(tr.iterations) == int(jr.iterations)
    assert bool(tr.converged) == bool(jr.converged)
    # the NaN coordinate reaches every centroid: the fit never converges
    # and every point takes index 0
    assert not bool(tr.converged)
    assert torch.isnan(tr.centroids[:, 0]).all()
    assert (tr.labels == 0).all()


def test_fit_stops_at_a_nan_shift_like_the_reference():
    """The two packages seed differently, so each fit is held to its own
    step 1: one iteration, not converged, the step-1 labels."""
    import jax

    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, 2)).astype(np.float32)
    x[:64] += 6.0
    x[7, 0] = np.nan
    jcfg, tcfg = jkm.KMeansConfig(k=2), tkm.KMeansConfig(k=2)
    key = jax.random.PRNGKey(0)
    jr = jkm.fit(key, jnp.asarray(x), jcfg)
    jstep = jkm.kmeans_step(jnp.asarray(x),
                            jkm.init_centroids(key, jnp.asarray(x), jcfg),
                            jcfg)[0]
    xt = torch.from_numpy(x)
    tr = tkm.fit(0, xt, tcfg)
    tstep = tkm.kmeans_step(xt, tkm.init_centroids(0, xt, tcfg), tcfg)[0]
    assert int(jr.iterations) == int(tr.iterations) == 1
    assert not bool(jr.converged) and not bool(tr.converged)
    np.testing.assert_array_equal(np.asarray(jr.labels), np.asarray(jstep))
    np.testing.assert_array_equal(tr.labels.numpy(), tstep.numpy())


def test_narrow_row_sums_keep_a_nan_row_in_its_own_centroid(monkeypatch):
    """The card's narrow-row route, by its plain twin on the host: the
    one-job fit of the case above gives the reference's labels and
    iterations, but only the NaN row's own centroid turns NaN."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, 2)).astype(np.float32)
    x[:64] += 6.0
    x[7, 0] = np.nan
    c0 = x[[0, 100]].copy()
    kw = dict(k=2, max_iters=20)
    jr = jkm.fit_cancellable(None, jnp.asarray(x), jkm.KMeansConfig(**kw),
                             centroids=jnp.asarray(c0))
    calls = []
    real = tkm.lloyd_sums

    def routed(xs, assign, k):
        calls.append(k)
        return real(xs, assign, k)

    monkeypatch.setattr(tkm, "lloyd_sums", routed)
    monkeypatch.setattr(tkm, "_takes_lloyd_kernel", lambda xs, cfg: True)
    tr = tkm.fit_cancellable(None, torch.from_numpy(x),
                             tkm.KMeansConfig(**kw),
                             centroids=torch.from_numpy(c0))
    assert len(calls) == int(tr.iterations) == int(jr.iterations)
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    assert (tr.labels == 0).all() and not bool(tr.converged)
    assert torch.isnan(tr.centroids[0, 0])
    assert torch.isfinite(tr.centroids[1]).all()
    # the step's sums themselves: NaN in the row's own centroid only
    xt = torch.from_numpy(x)
    idx = torch.zeros(128, dtype=torch.int32)
    idx[64:] = 1
    sums, counts = fops.lloyd_sums(xt, idx, 2)
    psums, pcounts = tkm._weighted_sums(xt, idx, 2)
    assert torch.equal(counts, pcounts)
    assert torch.isnan(sums[0, 0]) and torch.isfinite(sums[1]).all()
    assert torch.isnan(psums[:, 0]).all()
