"""Port parity: K-Means steps and loops against the reference package.

The same numpy inputs and explicit initial centroids go through both
packages (``jax.random`` seeding cannot be reproduced in torch).  The
reference runs its Pallas assignment kernel in interpret mode.
Assignments and iteration counts must match exactly; floats within
rtol = atol = 1e-5, the tolerance of tests/test_fused_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core.cancellation import CancellationToken as JaxToken
from repro.data.synthetic import ClusterSpec, make_blobs as jax_blobs
from repro_torch import convert
from repro_torch.core import kmeans as tkm
from repro_torch.core.cancellation import CancellationToken

TOL = dict(rtol=1e-5, atol=1e-5)


def _blobs(features, clusters, size, seed):
    x, _, _ = jax_blobs(jax.random.PRNGKey(seed),
                        ClusterSpec(features, clusters, size))
    return np.array(x)


def _init(x, k, seed):
    idx = np.random.default_rng(seed).choice(x.shape[0], k, replace=False)
    return x[idx].copy()


def _both_cfgs(k, **kw):
    return jkm.KMeansConfig(k=k, **kw), tkm.KMeansConfig(k=k, **kw)


@pytest.mark.parametrize("features,clusters,size", [(2, 4, 128), (4, 6, 64)])
def test_kmeans_step_matches(features, clusters, size):
    x = _blobs(features, clusters, size, seed=features * 10 + clusters)
    c = _init(x, clusters, seed=1)
    jcfg, tcfg = _both_cfgs(clusters)
    ja, jc, js, ji = jkm.kmeans_step(jnp.asarray(x), jnp.asarray(c), jcfg)
    ta, tc, ts, ti = tkm.kmeans_step(torch.from_numpy(x), torch.from_numpy(c),
                                     tcfg)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(ts), float(js), **TOL)
    np.testing.assert_allclose(float(ti), float(ji), **TOL)


def test_masked_kmeans_step_matches():
    x = _blobs(2, 5, 100, seed=3)
    c = _init(x, 5, seed=2)
    mask = np.random.default_rng(0).random(x.shape[0]) < 0.7
    jcfg, tcfg = _both_cfgs(5)
    ja, jc, js, ji = jkm.masked_kmeans_step(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask), jcfg)
    ta, tc, ts, ti = tkm.masked_kmeans_step(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(mask), tcfg)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(ts), float(js), **TOL)
    np.testing.assert_allclose(float(ti), float(ji), **TOL)
    # all-True mask is the unmasked step
    full = tkm.kmeans_step(torch.from_numpy(x), torch.from_numpy(c), tcfg)
    ones = tkm.masked_kmeans_step(torch.from_numpy(x), torch.from_numpy(c),
                                  torch.ones(x.shape[0], dtype=torch.bool), tcfg)
    for a, b in zip(full, ones):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_empty_cluster_keeps_its_center():
    x = _blobs(2, 3, 64, seed=4)
    c = np.concatenate([_init(x, 3, seed=0),
                        np.array([[1e4, 1e4]], np.float32)])
    jcfg, tcfg = _both_cfgs(4)
    _, jc, _, _ = jkm.kmeans_step(jnp.asarray(x), jnp.asarray(c), jcfg)
    _, tc, _, _ = tkm.kmeans_step(torch.from_numpy(x), torch.from_numpy(c), tcfg)
    np.testing.assert_array_equal(tc.numpy()[3], c[3])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("features,clusters,size", [(2, 4, 128), (1, 6, 128)])
def test_fit_cancellable_matches(features, clusters, size):
    x = _blobs(features, clusters, size, seed=features + clusters)
    c = _init(x, clusters, seed=7)
    jcfg, tcfg = _both_cfgs(clusters)
    jr = jkm.fit_cancellable(None, jnp.asarray(x), jcfg,
                             centroids=jnp.asarray(c))
    tr = tkm.fit_cancellable(None, torch.from_numpy(x), tcfg,
                             centroids=torch.from_numpy(c))
    assert tr.labels.dtype == torch.int16
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    assert int(tr.iterations) == int(jr.iterations)
    assert bool(tr.converged) == bool(jr.converged)
    np.testing.assert_allclose(tr.centroids.numpy(), np.asarray(jr.centroids),
                               **TOL)
    np.testing.assert_allclose(float(tr.inertia), float(jr.inertia), **TOL)


def _cancel_at(token, at):
    def hook(it, _shift):
        if it == at:
            token.cancel()
    return hook


def test_cancel_then_resume_reaches_uninterrupted_result():
    x = torch.from_numpy(_blobs(2, 6, 128, seed=8))
    cfg = tkm.KMeansConfig(k=6)
    full = tkm.fit_cancellable(3, x, cfg)
    tok = CancellationToken()
    part = tkm.fit_cancellable(3, x, cfg, tok, _cancel_at(tok, 2))
    assert part.cancelled and int(part.iterations) == 2
    assert not bool(part.converged)
    rest = tkm.fit_cancellable(None, x, cfg, centroids=part.centroids,
                               start_iteration=int(part.iterations))
    assert int(rest.iterations) == int(full.iterations)
    np.testing.assert_array_equal(rest.labels.numpy(), full.labels.numpy())
    np.testing.assert_array_equal(rest.centroids.numpy(),
                                  full.centroids.numpy())


def test_suspended_reference_run_resumes_in_port():
    x = _blobs(2, 4, 128, seed=12)
    c = _init(x, 4, seed=5)
    jcfg, tcfg = _both_cfgs(4)
    jfull = jkm.fit_cancellable(None, jnp.asarray(x), jcfg,
                                centroids=jnp.asarray(c))
    tok = JaxToken()
    jpart = jkm.fit_cancellable(None, jnp.asarray(x), jcfg, tok,
                                _cancel_at(tok, 1), centroids=jnp.asarray(c))
    assert jpart.cancelled
    state = convert.kmeans_result_from_numpy(
        {f: np.asarray(getattr(jpart, f)) for f in
         ("centroids", "labels", "inertia", "iterations", "converged")},
        cancelled=True)
    rest = tkm.fit_cancellable(None, convert.points_from_numpy(x), tcfg,
                               centroids=state.centroids,
                               start_iteration=int(state.iterations))
    assert int(rest.iterations) == int(jfull.iterations)
    np.testing.assert_array_equal(rest.labels.numpy(), np.asarray(jfull.labels))
    back = convert.kmeans_result_to_numpy(rest)
    assert back["labels"].dtype == np.int16
    np.testing.assert_allclose(back["centroids"], np.asarray(jfull.centroids),
                               **TOL)


def test_minibatch_step_matches():
    x = _blobs(2, 4, 64, seed=13)
    c = _init(x, 4, seed=3)
    counts = np.array([0, 3, 10, 1], np.float32)
    xb = x[np.random.default_rng(1).choice(x.shape[0], 64)]
    jcfg, tcfg = _both_cfgs(4)
    js = jkm.minibatch_step(
        jkm.MiniBatchState(jnp.asarray(c), jnp.asarray(counts), 2, 100),
        jnp.asarray(xb), jcfg)
    ts = tkm.minibatch_step(
        tkm.MiniBatchState(torch.from_numpy(c), torch.from_numpy(counts), 2, 100),
        torch.from_numpy(xb), tcfg)
    assert (ts.step, ts.n_seen) == (js.step, js.n_seen) == (3, 164)
    np.testing.assert_allclose(ts.centroids.numpy(), np.asarray(js.centroids),
                               **TOL)
    np.testing.assert_allclose(ts.counts.numpy(), np.asarray(js.counts), **TOL)
    again = tkm.MiniBatchState.from_tree(ts.as_tree())
    np.testing.assert_array_equal(again.centroids.numpy(), ts.centroids.numpy())


def test_port_seeding_is_deterministic_and_fits():
    x = torch.from_numpy(_blobs(2, 4, 128, seed=14))
    for init in ("sample", "kmeans++"):
        cfg = tkm.KMeansConfig(k=4, init=init)
        a = tkm.init_centroids(11, x, cfg)
        b = tkm.init_centroids(torch.Generator().manual_seed(11), x, cfg)
        assert a.shape == (4, 2)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    res = tkm.fit(0, x, tkm.KMeansConfig(k=4))
    assert bool(res.converged) and res.labels.shape == (512,)
    mb = tkm.minibatch_fit(0, x, tkm.KMeansConfig(k=4), batch_size=64, steps=20)
    assert mb.centroids.shape == (4, 2) and torch.isfinite(mb.inertia)
