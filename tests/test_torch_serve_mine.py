"""The port's service launcher (the reference's serve_mine CLI), on the
CPU: a mixed workload drains with zero failures and prints the scorecard;
the fleet form (two worker processes, a rolling restart, a fleet-wide
reload) and the standby form do too, and the parser refuses the flag
mixes the reference refuses."""

import numpy as np
import pytest
import torch

from repro_torch.launch import serve_mine


def test_serve_mine_cli_on_cpu(tmp_path, capsys):
    failures = serve_mine.run([
        "--device", "cpu", "--workdir", str(tmp_path), "--requests", "6",
        "--tenants", "2", "--algo", "mixed", "--rate", "500",
        "--points", "24", "--executor", "cuda-kernel",
        "--warm-start", '[{"algo": "kmeans", "features": 2, "n": 96, '
                        '"k": 4, "max_iters": 50}]'])
    assert failures == {"suspended": 0, "dropped": 0, "rejected": 0}
    out = capsys.readouterr().out
    assert "# 6 requests, p50" in out and "'cuda-kernel'" in out
    assert ("failures {'suspended': 0, 'dropped': 0, 'rejected': 0}"
            in out)
    for line in ("# bucketing [", "# energy: ", "# slo: "):
        assert line in out, line


def test_build_workload_is_seeded_per_request():
    a = serve_mine.build_workload(4, 2, "mixed", points=16, seed=3)
    b = serve_mine.build_workload(4, 2, "mixed", points=16, seed=3)
    assert [w[1] for w in a] == ["dbscan", "kmeans", "dbscan", "kmeans"]
    for (ta, _, xa, pa), (tb, _, xb, pb) in zip(a, b):
        assert ta == tb and pa == pb
        np.testing.assert_array_equal(xa, xb)
    assert not np.array_equal(a[0][2], a[2][2])   # requests differ
    # unequal cluster sizes between min_points and points
    w = serve_mine.build_workload(3, 1, "kmeans", clusters=4, points=40,
                                  min_points=30, seed=1)
    sizes = [x.shape[0] for _, _, x, _ in w]
    assert all(120 <= s <= 160 for s in sizes) and len(set(sizes)) > 1
    gen = serve_mine.request_generator(1, 2)
    assert isinstance(gen, torch.Generator)


def test_main_entry_point_runs_the_cli(tmp_path, capsys):
    assert serve_mine.main([
        "--device", "cpu", "--workdir", str(tmp_path), "--requests", "2",
        "--algo", "dbscan", "--points", "16", "--executor", "numpy-mt"]) \
        is None
    assert "# 2 requests, p50" in capsys.readouterr().out


def test_drive_collects_results_in_order(tmp_path):
    workload = serve_mine.build_workload(3, 3, "dbscan", points=16, seed=5)
    with serve_mine.MiningClient(str(tmp_path), device="cpu",
                                 max_wait_s=0.001) as client:
        results = []
        failures = serve_mine.drive(client, workload, rate=0,
                                    executor="torch-ref", results=results)
    assert failures == {"suspended": 0, "dropped": 0, "rejected": 0}
    assert [r["algo"] for r in results] == ["dbscan"] * 3
    for (_, _, x, _), r in zip(workload, results):
        assert r["labels"].shape == (x.shape[0],)


@pytest.mark.parametrize("argv, message", [
    (["--fleet", "2", "--standby", "127.0.0.1:1"], "single-process mode"),
    (["--rolling-restart"], "needs --fleet"),
])
def test_parser_refuses_what_the_reference_refuses(tmp_path, capsys, argv,
                                                   message):
    with pytest.raises(SystemExit) as ei:
        serve_mine.run(["--device", "cpu", "--workdir", str(tmp_path),
                        *argv])
    assert ei.value.code == 2
    assert message in capsys.readouterr().err


def test_fleet_cli_rolls_its_workers_on_cpu(tmp_path, capsys):
    failures = serve_mine.run([
        "--device", "cpu", "--workdir", str(tmp_path), "--fleet", "2",
        "--router-port", "0", "--requests", "4", "--tenants", "2",
        "--algo", "mixed", "--rate", "0", "--points", "16",
        "--executor", "cuda-kernel", "--rolling-restart",
        "--reload", '{"tenant_rate": 500}'])
    assert failures == {"suspended": 0, "dropped": 0, "rejected": 0}
    out = capsys.readouterr().out
    assert "# fleet telemetry: http://127.0.0.1:" in out
    assert "converged True" in out
    assert out.count("# rolling restart: worker-") == 2
    assert ("post-restart batch failures {'suspended': 0, 'dropped': 0, "
            "'rejected': 0}" in out)
    assert "# fleet: 2/2 workers alive" in out


def test_standby_cli_ships_the_whole_wal(tmp_path, capsys):
    from repro_torch.service import StandbyReplica
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    try:
        failures = serve_mine.run([
            "--device", "cpu", "--workdir", str(tmp_path / "primary"),
            "--requests", "3", "--algo", "kmeans", "--points", "16",
            "--rate", "0", "--executor", "torch-ref",
            "--standby", f"127.0.0.1:{standby.port}"])
        assert failures == {"suspended": 0, "dropped": 0, "rejected": 0}
        out = capsys.readouterr().out
        assert f"# replicating WAL to standby 127.0.0.1:{standby.port}" in out
        assert "lag 0 entries, 0 ship errors" in out
        assert standby.stats()["applied_entry_id"] == 3
    finally:
        standby.stop()
