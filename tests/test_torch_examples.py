"""The port's tour examples (``repro_torch.examples``) against the
reference's ``examples/``.

Each of the four runs to its end as ``python -m repro_torch.examples.<name>
--device cpu`` and prints the reference's fields; without ``--device`` on
a machine with no card each raises instead of running on the host.
Parities, on the reference's own draws carried across as numpy:
quickstart's K-Means (from the reference's initial centroids) and DBSCAN
give the reference's labels exactly; embedding clustering's pooled points
equal the reference's within 1e-6 and its logits within 1e-4 for the same
params (``convert.lm_params_from_jax``) and tokens, and its K-Means from the
reference's k-means++ centroids gives the reference's labels.  The
reference runs its plain paths (``use_kernel=False``), as the port's
wrappers do on CPU tensors.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import dbscan as jax_dbscan, kmeans as jax_kmeans
from repro.data.synthetic import make_blobs as jax_make_blobs
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import kmeans
from repro_torch.examples import (
    embedding_clustering,
    mine_cluster,
    quickstart,
    service_demo,
)
from repro_torch.service import StreamingSession

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = {"quickstart": quickstart, "mine_cluster": mine_cluster,
            "service_demo": service_demo,
            "embedding_clustering": embedding_clustering}
NUM = r"-?[\d.]+"
# the lines each example prints, as the reference's example prints them
EXPECTED = {
    "quickstart": [
        r"^backend: cpu x1 \(chip: host_cpu\)$",
        r"^dataset: 6144 points, 2 features$",
        rf"^kmeans:  \d+ iterations, inertia {NUM}, converged=True$",
        r"^dbscan:  \d+ clusters, \d+ noise points, \d+ "
        r"expansion-kernel launches$",
    ],
    "mine_cluster": [
        r"^workdir: ",
        *[rf"^{algo} +f={f} c={c} s={s}: SUCCEEDED in {NUM}s "
          rf"\({'iters' if algo == 'kmeans' else 'clusters'}=\d+\)$"
          for f, c, s in mine_cluster.GRID for algo in mine_cluster.ALGOS],
        rf"^cancelled job -> (SUSPENDED \(cancelled=True\)|SUCCEEDED "
        rf"\(cancelled=False\)) after {NUM}s$",
        *[rf"^  job {i}: mine (SUCCEEDED|SUSPENDED) progress=\{{"
          for i in range(1, 8)],
    ],
    "embedding_clustering": [
        rf"^clustered 32 documents into 4 groups: sizes=\[\d+, \d+, \d+, "
        rf"\d+\], inertia={NUM}, iters=\d+$",
    ],
    "service_demo": [
        r"^== async multi-tenant serving ==$",
        # (the done callback prints from a service thread, so its line may
        # run into a handle's line: those are matched unanchored)
        *[rf"{t} +dbscan -> \d+ clusters, \d+ noise +\[[a-z-]+, \d+ms\]"
          for t in ("alice", "bob", "alice", "bob")],
        rf"alice kmeans -> inertia {NUM} in \d+ iters +\[[a-z-]+, \d+ms\]",
        rf"^== cache == repeated dataset: hit=True \({NUM}ms\)$",
        r"^== streaming ==$",
        r"^  stream step \d+, \d+ points folded in$",
        r"^  reopened stream at step \d+ \(centroids intact: True\)$",
        r"^== preemption ==$",
        r"^  (preempted: batch job \d+ SUSPENDED with checkpoint|"
        r"\(batch finished before the preemption landed)",
        r"^== metrics ==$",
        rf"^  requests=\d+ batches=\d+ occupancy={NUM} lanes=\{{.*\}} "
        rf"suspended=\d+ modeled_joules={NUM}$",
    ],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_host_and_prints_the_reference_fields(name):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    at = 0
    for pattern in EXPECTED[name]:   # in order, other lines between
        while at < len(lines) and not re.search(pattern, lines[at]):
            at += 1
        assert at < len(lines), (pattern, proc.stdout)
        at += 1


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])


def test_quickstart_matches_the_reference():
    spec = quickstart.SPEC
    x, _, _ = jax_make_blobs(jax.random.PRNGKey(0), spec)
    xn = np.array(x, np.float32)
    jcfg = jax_kmeans.KMeansConfig(k=spec.clusters, use_kernel=False)
    jres = jax_kmeans.fit(jax.random.PRNGKey(1), xn, jcfg)
    c0 = np.asarray(jax_kmeans.init_centroids(jax.random.PRNGKey(1), xn,
                                              jcfg))
    xt = torch.from_numpy(xn)
    # quickstart's own fit is this config's Lloyd loop from seed 1 ...
    kcfg = kmeans.KMeansConfig(k=spec.clusters)
    own = quickstart.run_kmeans(xt, spec.clusters)
    twin = kmeans.fit_cancellable(1, xt, kcfg)
    assert torch.equal(own.labels, twin.labels)
    assert int(own.iterations) == int(twin.iterations)
    # ... which, from the reference's initial centroids, ends where it does
    kres = kmeans.fit_cancellable(None, xt, kcfg,
                                  centroids=torch.from_numpy(c0))
    np.testing.assert_array_equal(kres.labels.numpy(),
                                  np.asarray(jres.labels))
    assert int(kres.iterations) == int(jres.iterations)
    assert bool(kres.converged) == bool(jres.converged)
    np.testing.assert_allclose(float(kres.inertia), float(jres.inertia),
                               rtol=1e-5)

    dcfg = jax_dbscan.DBSCANConfig.paper_defaults(spec.features)
    jdb = jax_dbscan.fit(xn, jax_dbscan.DBSCANConfig(
        eps=dcfg.eps, min_pts=dcfg.min_pts, use_kernel=False))
    dres = quickstart.run_dbscan(torch.from_numpy(xn), spec.features)
    np.testing.assert_array_equal(dres.labels.numpy(), np.asarray(jdb.labels))
    assert int(dres.n_clusters) == int(jdb.n_clusters)
    assert int(dres.expansions) == int(jdb.expansions)


def test_embedding_clustering_matches_the_reference():
    jcfg = jax_smoke("olmo-1b")
    cfg = get_smoke_config("olmo-1b")
    key = jax.random.PRNGKey(0)
    jparams = jax_lm.init_params(key, jcfg)
    toks = np.asarray(jax.random.randint(
        jax.random.fold_in(key, 1), (embedding_clustering.B,
                                     embedding_clustering.S), 0, jcfg.vocab))
    jlogits, _ = jax.jit(lambda p, t: jax_lm.forward(p, t, jcfg))(jparams,
                                                                  toks)
    jemb = jparams["embed"][toks].mean(axis=1)
    jemb = jemb / (jax.numpy.linalg.norm(jemb, axis=-1, keepdims=True)
                   + 1e-6)
    jemb = np.asarray(jemb, np.float32)

    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    emb, logits = embedding_clustering.embed_documents(
        params, torch.from_numpy(toks).long(), cfg)
    assert emb.dtype == torch.float32
    np.testing.assert_allclose(emb.numpy(), jemb, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    kcfg = jax_kmeans.KMeansConfig(k=embedding_clustering.K,
                                   init="kmeans++", use_kernel=False)
    jx = jax.numpy.asarray(jemb)
    jres = jax_kmeans.fit(jax.random.PRNGKey(2), jx, kcfg)
    c0 = np.asarray(jax_kmeans.init_centroids(jax.random.PRNGKey(2), jx,
                                              kcfg))
    et = torch.from_numpy(jemb)
    # the example's own fit is this config's Lloyd loop from seed 2 ...
    ecfg = kmeans.KMeansConfig(k=embedding_clustering.K, init="kmeans++")
    own = embedding_clustering.cluster(et)
    twin = kmeans.fit_cancellable(2, et, ecfg)
    assert torch.equal(own.labels, twin.labels)
    assert int(own.iterations) == int(twin.iterations)
    # ... which, from the reference's k-means++ centroids, ends where it does
    res = kmeans.fit_cancellable(None, et, ecfg,
                                 centroids=torch.from_numpy(c0))
    np.testing.assert_array_equal(res.labels.numpy(),
                                  np.asarray(jres.labels))
    assert int(res.iterations) == int(jres.iterations)


def test_service_demo_acts_on_the_host(tmp_path):
    out = service_demo.run(str(tmp_path), "cpu")
    assert len(out["results"]) == 5
    assert [r["algo"] for r in out["results"]] == ["dbscan"] * 4 + ["kmeans"]
    assert out["cache_hit"] and out["stream_intact"]
    # small work goes to the host lane (the cost model's little class);
    # act 4 pins torch-ref
    assert set(out["lanes_acts_1_3"]) == {"numpy-mt"}
    assert {n for n, st in out["metrics"]["lanes"].items()
            if st["batches"]} == {"torch-ref"}
    assert out["stream_after"]["step"] == out["stream_before"]["step"] >= 1
    if not out["finished_first"]:
        (resumed,) = out["resumed"]
        assert resumed.resumed and not resumed.suspended
    # the dropped stream reopens from its checkpoint in a new session
    sess = StreamingSession(
        os.path.join(str(tmp_path), "streams"),
        service_demo.STREAM["tenant"], service_demo.STREAM["name"],
        k=service_demo.STREAM["k"],
        batch_size=service_demo.STREAM["batch_size"], device="cpu")
    np.testing.assert_array_equal(sess.snapshot()["centroids"],
                                  out["stream_after"]["centroids"])
