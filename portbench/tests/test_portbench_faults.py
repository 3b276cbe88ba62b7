"""The check fails what it must: the control (the plain reference with
TF32 products in the program's place) and a run whose timed path is
broken underneath, once for each fault the cell can have.  On the host,
at sizes the tests hold; the harness's look for a card is skipped."""

import pytest
from portbench import readings, run, spec

from portbench.tests.sizes import small_config

SEED = 2**31 + 29


def _correct(cell, cfg=None):
    bench = spec.benchmark()
    cfg = cfg or small_config(spec.cell(bench, cell)["config"])
    return run.run_cell(cell, SEED, 0.2, False, device="cpu",
                        config=cfg)["correct"]


def _over(cell, numbers):
    lim = spec.limits(cell)["numbers"]
    return any(numbers[k] > float(v["limit"]) for k, v in lim.items())


@pytest.mark.parametrize("cell", ["kmeans-d4.fit", "dbscan-d4.fit"])
def test_control_fails(cell):
    cfg = small_config(spec.cell(spec.benchmark(), cell)["config"])
    for r in readings.readings(cell, [], [1, 2, 3], device="cpu",
                               config=cfg):
        assert _over(cell, r["numbers"]), r


def _kmeans_faults(monkeypatch, fault):
    from repro_torch.core import kmeans

    if fault == "unchanged":
        monkeypatch.setattr(kmeans, "_update_centroids",
                            lambda x, assign, k, c_old: c_old)
    elif fault == "half":
        sums = kmeans._weighted_sums
        monkeypatch.setattr(
            kmeans, "_weighted_sums",
            lambda x, a, k, w=None: sums(x[::2], a[::2], k,
                                         None if w is None else w[::2]))
    else:
        _alter_answer(monkeypatch)


def _alter_answer(monkeypatch):
    """The job's answer altered where it is made: 8 labels moved on."""
    from repro_torch.core import kmeans

    result = kmeans.KMeansResult

    def altered(**kw):
        labels = kw["labels"].clone()
        k = kw["centroids"].shape[0]
        labels[:8] = ((labels[:8].long() + 1) % k).to(labels.dtype)
        return result(**dict(kw, labels=labels))

    monkeypatch.setattr(kmeans, "KMeansResult", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_kmeans_fit_faults(monkeypatch, fault):
    _kmeans_faults(monkeypatch, fault)
    assert _correct("kmeans-d4.fit") is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "degree"])
def test_dbscan_faults(monkeypatch, fault):
    from repro_torch.core import dbscan

    if fault == "unchanged":   # an expansion that reaches nothing new
        monkeypatch.setattr(dbscan, "_expand",
                            lambda x, frontier, cfg: frontier.clone())
    elif fault == "half":      # half the points' degrees left out
        degree = dbscan._degree

        def half(x, cfg):
            deg = degree(x, cfg).clone()
            deg[x.shape[0] // 2:] = 0
            return deg

        monkeypatch.setattr(dbscan, "_degree", half)
    elif fault == "degree":    # one point's eps-degree counted one over
        from repro_torch.kernels.neighbor import ops

        degree = ops.epsilon_degree

        def over(x, eps):
            deg = degree(x, eps).clone()
            deg[0] += 1
            return deg

        monkeypatch.setattr(ops, "epsilon_degree", over)
        monkeypatch.setattr(dbscan, "epsilon_degree", over)
    else:
        finish = dbscan.finish

        def altered(word):
            out = finish(word).clone()
            out[0] += 1
            return out

        monkeypatch.setattr(dbscan, "finish", altered)
    assert _correct("dbscan-d4.fit") is False
