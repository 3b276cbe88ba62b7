"""Port parity: DBSCAN against the reference package and the sequential
oracle.  Labels, core mask, cluster count and expansion count must be
bit-identical; a run suspended in one package must finish in the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbscan as jdb
from repro.core.cancellation import CancellationToken as JaxToken
from repro.data.synthetic import ClusterSpec, make_blobs as jax_blobs
from repro_torch import convert
from repro_torch.core import dbscan as tdb
from repro_torch.core.cancellation import CancellationToken


def _blobs(features, clusters, size, seed):
    x, _, _ = jax_blobs(jax.random.PRNGKey(seed),
                        ClusterSpec(features, clusters, size))
    return np.array(x)


def _cfgs(features):
    j = jdb.DBSCANConfig.paper_defaults(features)
    t = tdb.DBSCANConfig.paper_defaults(features)
    assert (t.eps, t.min_pts) == (j.eps, j.min_pts)
    return j, t


@pytest.mark.parametrize("features,clusters,size", [(1, 2, 128), (2, 6, 128),
                                                    (4, 4, 64), (2, 8, 256)])
def test_dbscan_matches_reference_and_oracle(features, clusters, size):
    x = _blobs(features, clusters, size, seed=features * 100 + clusters * 10)
    jcfg, tcfg = _cfgs(features)
    jres, _ = jdb.fit_resumable(jnp.asarray(x), jcfg)
    tres, snap = tdb.fit_resumable(torch.from_numpy(x), tcfg)
    assert snap is None and not tres.cancelled
    assert tres.labels.dtype == torch.int16
    np.testing.assert_array_equal(tres.labels.numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(tres.core_mask.numpy(),
                                  np.asarray(jres.core_mask))
    assert int(tres.n_clusters) == int(jres.n_clusters)
    assert int(tres.expansions) == int(jres.expansions)
    np.testing.assert_array_equal(tres.labels.numpy(),
                                  tdb.fit_oracle(x, tcfg))
    np.testing.assert_array_equal(tdb.fit_oracle(x, tcfg),
                                  jdb.fit_oracle(x, jcfg))
    plain = tdb.fit(torch.from_numpy(x), tdb.DBSCANConfig(
        eps=tcfg.eps, min_pts=tcfg.min_pts, use_kernel=False))
    np.testing.assert_array_equal(plain.labels.numpy(), tres.labels.numpy())


def test_state_word_roundtrip_and_guard():
    labels = torch.tensor([0, 1, 5, tdb.MAX_CLUSTER_ID], dtype=torch.int32)
    vis = torch.tensor([True, True, False, True])
    mem = torch.tensor([False, True, False, True])
    core = torch.tensor([False, True, True, False])
    w = tdb.pack_state(labels, vis, mem, core)
    assert w.dtype == torch.int16
    jw = jdb.pack_state(jnp.asarray(labels.numpy()), jnp.asarray(vis.numpy()),
                        jnp.asarray(mem.numpy()), jnp.asarray(core.numpy()))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    for a, b in zip(tdb.unpack_state(w), (labels, vis, mem, core)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(tdb.finish(w).numpy(), labels.numpy())
    bad = torch.full((4,), tdb.MAX_CLUSTER_ID + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int16 state word"):
        tdb.pack_state(bad, vis, mem, core)


def test_cluster_id_overflow_raises_in_the_loop():
    x = torch.from_numpy(_blobs(2, 2, 64, seed=1))
    n = x.shape[0]
    state = tdb.DBSCANRunState(packed=np.zeros(n, np.int16),
                               frontier=np.zeros(n, bool),
                               cid=tdb.MAX_CLUSTER_ID, nexp=0)
    with pytest.raises(ValueError, match="cannot represent cluster id"):
        tdb.fit_resumable(x, tdb.DBSCANConfig.paper_defaults(2), state=state)


def test_valid_mask_matches_reference():
    x = _blobs(2, 3, 64, seed=2)
    pad = np.arange(16, dtype=np.float32)[:, None].repeat(2, 1) * 1e3 + 1e4
    xp = np.concatenate([x, pad])
    mask = np.arange(xp.shape[0]) < x.shape[0]
    jcfg = jdb.DBSCANConfig(eps=1.0, min_pts=1)
    tcfg = tdb.DBSCANConfig(eps=1.0, min_pts=1)
    jres, _ = jdb.fit_resumable(jnp.asarray(xp), jcfg,
                                valid_mask=jnp.asarray(mask))
    tres, _ = tdb.fit_resumable(torch.from_numpy(xp), tcfg,
                                valid_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tres.labels.numpy(), np.asarray(jres.labels))
    assert (tres.labels.numpy()[~mask] == 0).all()   # no phantom clusters
    assert int(tres.n_clusters) == int(jres.n_clusters)


def _cancel_after(token, nexp_stop):
    def hook(_cid, nexp):
        if nexp == nexp_stop:
            token.cancel()
    return hook


def test_on_state_snapshots_resume_exactly():
    x = torch.from_numpy(_blobs(2, 4, 128, seed=3))
    cfg = tdb.DBSCANConfig.paper_defaults(2)
    full, _ = tdb.fit_resumable(x, cfg)
    snaps = []
    tdb.fit_resumable(x, cfg, on_state=snaps.append, state_interval=3)
    assert snaps and all(s.nexp % 3 == 0 for s in snaps)
    res, _ = tdb.fit_resumable(x, cfg, state=snaps[len(snaps) // 2])
    np.testing.assert_array_equal(res.labels.numpy(), full.labels.numpy())
    assert int(res.expansions) == int(full.expansions)


def test_reference_run_suspended_mid_bfs_finishes_in_port():
    x = _blobs(2, 6, 128, seed=4)
    jcfg, tcfg = _cfgs(2)
    tok = JaxToken()
    jres, jsnap = jdb.fit_resumable(jnp.asarray(x), jcfg, tok,
                                    on_progress=_cancel_after(tok, 2))
    assert jres.cancelled and jsnap is not None
    assert jsnap.frontier.any()          # suspended mid-BFS
    state = convert.dbscan_state_from_tree(jsnap.as_tree())
    tres, snap = tdb.fit_resumable(convert.points_from_numpy(x), tcfg,
                                   state=state)
    assert snap is None
    np.testing.assert_array_equal(tres.labels.numpy(), jdb.fit_oracle(x, jcfg))
    jfull, _ = jdb.fit_resumable(jnp.asarray(x), jcfg)
    assert int(tres.expansions) == int(jfull.expansions)
    assert int(tres.n_clusters) == int(jfull.n_clusters)


def test_port_run_suspended_mid_bfs_finishes_in_reference():
    x = _blobs(2, 6, 128, seed=5)
    jcfg, tcfg = _cfgs(2)
    tok = CancellationToken()
    tres, tsnap = tdb.fit_resumable(torch.from_numpy(x), tcfg, tok,
                                    on_progress=_cancel_after(tok, 4))
    assert tres.cancelled and tsnap is not None and tsnap.frontier.any()
    tree = tsnap.as_tree()
    jres, jsnap = jdb.fit_resumable(jnp.asarray(x), jcfg,
                                    state=jdb.DBSCANRunState.from_tree(tree))
    assert jsnap is None
    np.testing.assert_array_equal(np.asarray(jres.labels),
                                  tdb.fit_oracle(x, tcfg))


def test_convert_rejects_malformed_state():
    with pytest.raises(TypeError):
        convert.dbscan_state_from_tree({"packed": np.zeros(4, np.int32),
                                        "frontier": np.zeros(4, bool),
                                        "cid": 0, "nexp": 0})
    with pytest.raises(ValueError):
        convert.dbscan_state_from_tree({"packed": np.zeros(4, np.int16),
                                        "frontier": np.zeros(3, bool),
                                        "cid": 0, "nexp": 0})


def test_cancel_before_start_stops_fast():
    x = torch.from_numpy(_blobs(2, 8, 256, seed=5))
    tok = CancellationToken()
    tok.cancel()
    res = tdb.fit_cancellable(x, tdb.DBSCANConfig.paper_defaults(2), tok)
    assert res.cancelled and int(res.expansions) == 0
