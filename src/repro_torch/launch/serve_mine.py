"""Clustering-as-a-service launcher: drive the batched mining service.

Generates a synthetic multi-tenant workload (the paper's dataset grid as
request traffic), submits it at an offered rate through the async
:class:`~repro_torch.service.MiningClient`, and prints the serving
scorecard — p50/p99 latency, batch occupancy, per-lane busy time, cache
hits, and the modeled energy spend per paradigm.  Backpressure is
honoured: when admission sheds load with ``BacklogFull``, :func:`drive`
sleeps the rejected request's ``retry_after`` estimate and resubmits
instead of hammering the door.  ``--resume`` first completes any batches a
previous (killed) process left SUSPENDED; ``--recover`` additionally
replays every admitted-but-unbatched request from the write-ahead
admission log, so a ``kill -9`` at any moment loses nothing that was
admitted.  ``--bucket-policy`` picks how batch shapes are padded (``pow2``
/ ``linear[:STEP]`` / ``adaptive``, the self-tuning default).

``--fleet N`` runs the workload through N worker processes behind the
consistent-hash router (``--router-port`` serves the fleet exposition,
``--rolling-restart`` restarts every worker one at a time afterwards);
``--standby HOST:PORT`` ships the single-process service's WAL to a warm
standby for the whole run.

The service runs on the CUDA card unless ``--device cpu`` is given; with no
card and no ``--device cpu`` it raises instead of running on the host (a
fleet worker exits before it announces, and the manager raises).

    PYTHONPATH=src python -m repro_torch.launch.serve_mine \
        --workdir "$(mktemp -d)" --requests 32 --tenants 4 --rate 100 \
        --algo mixed --executor cuda-kernel

    # three worker processes sharing the card, then a rolling restart
    PYTHONPATH=src python -m repro_torch.launch.serve_mine \
        --fleet 3 --router-port 0 --requests 18 --rolling-restart
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import dbscan
from repro_torch.data.synthetic import ClusterSpec, make_blobs
from repro_torch.runtime import backend as backend_mod
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.service import (
    BacklogFull,
    ClusteringService,
    EnergyBudgetExceeded,
    JobSuspended,
    MiningClient,
    TelemetryServer,
    chrome_trace,
)

MAX_RESUBMITS = 3
# An energy-budget rejection whose refill takes longer than this is shed
# immediately — a load generator shouldn't stall the offered rate waiting
# for one tenant's joule bucket.
MAX_ENERGY_WAIT_S = 2.0


def request_generator(seed: int, i: int) -> torch.Generator:
    """The generator of request ``i`` of a workload seeded ``seed``."""
    state = np.random.SeedSequence([int(seed), int(i)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def build_workload(n_requests: int, tenants: int, algo: str, *,
                   features: int = 2, clusters: int = 4,
                   points: int = 64, seed: int = 0,
                   min_points: Optional[int] = None):
    """(tenant, algo, data, params) tuples from the paper's generator.

    Request ``i`` draws from :func:`request_generator` ``(seed, i)``.  With
    ``min_points`` each cluster of a request has between ``min_points`` and
    ``points`` points (unequal requests pad to a shared bucket); otherwise
    every cluster has ``points``.
    """
    cfg = dbscan.DBSCANConfig.paper_defaults(features)
    out = []
    for i in range(n_requests):
        this_algo = algo if algo != "mixed" else ("dbscan", "kmeans")[i % 2]
        gen = request_generator(seed, i)
        sizes = None
        if min_points is not None:
            sizes = torch.randint(int(min_points), int(points) + 1,
                                  (clusters,), generator=gen).tolist()
        x, _, _ = make_blobs(gen, ClusterSpec(features, clusters, points),
                             sizes=sizes)
        params = (
            {"eps": cfg.eps, "min_pts": cfg.min_pts}
            if this_algo == "dbscan"
            else {"k": clusters, "seed": i, "max_iters": 50}
        )
        out.append((f"tenant-{i % tenants}", this_algo, x.numpy(), params))
    return out


def submit_with_backoff(client: MiningClient, tenant, algo, data, *,
                        params, executor=None, ttl=None):
    """Submit one request, honouring BacklogFull.retry_after on rejection."""
    for attempt in range(MAX_RESUBMITS):
        try:
            return client.submit(tenant, algo, data, params=params,
                                 executor=executor, ttl=ttl)
        except BacklogFull as e:
            if attempt + 1 == MAX_RESUBMITS:
                break              # shedding anyway; don't sleep for it
            time.sleep(e.retry_after)
        except EnergyBudgetExceeded as e:
            if e.retry_after > MAX_ENERGY_WAIT_S or attempt + 1 == MAX_RESUBMITS:
                break              # joule refill too slow — shed the request
            time.sleep(e.retry_after)
    return None   # shed after MAX_RESUBMITS rejects


def drive(client: MiningClient, workload, rate: float,
          executor: str | None, timeout: float = 300.0,
          ttl: float | None = None,
          results: Optional[List[Optional[dict]]] = None) -> dict:
    """Submit at the offered rate; wait for every handle; count failures.

    ``results``, when given, receives each request's result in workload
    order (None for a rejected or failed request).
    """
    handles = []
    gap = 1.0 / rate if rate > 0 else 0.0
    failures = {"suspended": 0, "dropped": 0, "rejected": 0}
    t0 = time.time()
    for i, (tenant, algo, data, params) in enumerate(workload):
        target = t0 + i * gap
        delay = target - time.time()
        if delay > 0:
            time.sleep(delay)
        h = submit_with_backoff(client, tenant, algo, data, params=params,
                                executor=executor, ttl=ttl)
        if h is None:
            failures["rejected"] += 1
        handles.append(h)
    for h in handles:
        result = None
        if h is not None:
            try:
                result = h.result(timeout)
            except JobSuspended:
                failures["suspended"] += 1
            except Exception:        # RequestDropped, deadline expiry, ...
                failures["dropped"] += 1
        if results is not None:
            results.append(result)
    return failures


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface (separate so the docs gate can introspect it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="service state: WAL, jobs, checkpoints, cache "
                         "(default: a new directory under TMPDIR)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="offered load, requests/s")
    ap.add_argument("--algo", choices=("dbscan", "kmeans", "mixed"),
                    default="mixed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device lanes run (default: the CUDA "
                         "card; raises without one)")
    ap.add_argument("--executor",
                    choices=("auto", "cuda-kernel", "torch-ref", "numpy-mt"),
                    default="auto")
    ap.add_argument("--features", type=int, default=2)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--points", type=int, default=64,
                    help="points per cluster per request")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="per-device memory budget; requests whose working "
                         "set exceeds it are refused at admission "
                         "(default: a fraction of the card's memory)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--no-continuous", action="store_true",
                    help="disable continuous batching (on by default): "
                         "batches then run to completion before queued "
                         "requests dispatch, instead of compatible "
                         "requests joining in-flight batches at iteration "
                         "boundaries and finished items retiring early")
    ap.add_argument("--join-window", type=float, default=None,
                    help="seconds after a continuous batch starts during "
                         "which queued compatible requests may join it "
                         "(default: open for the batch's whole lifetime)")
    ap.add_argument("--warm-start", default=None,
                    help="pre-compile executables at startup from a JSON "
                         "list of shape specs, e.g. "
                         "'[{\"algo\": \"kmeans\", \"features\": 2, "
                         "\"n\": 1024, \"k\": 4}]' — the kernels are "
                         "built and each step launched once at start, so "
                         "first requests hit the step cache")
    ap.add_argument("--bucket-policy", default="adaptive",
                    help="batch-shape bucket policy: 'pow2', "
                         "'linear[:STEP]', or 'adaptive[:MAX_BUCKETS"
                         "[:REFIT_EVERY]]' (default: adaptive — behaves "
                         "like pow2 until fitted; see "
                         "docs/bucketing_study.md)")
    ap.add_argument("--ttl", type=float, default=None,
                    help="per-request deadline, seconds from submit")
    ap.add_argument("--power-cap", type=float, default=None,
                    help="service-wide dispatch power cap, watts: lanes "
                         "acquire each batch's predicted joules from a "
                         "token bucket refilled at this rate, so modeled "
                         "draw stays at or under the cap (latency is "
                         "traded for energy; see docs/energy_study.md)")
    ap.add_argument("--joule-rate", type=float, default=None,
                    help="per-tenant joule budget refill rate, J/s: "
                         "admission prices each request with the device-"
                         "class cost model and rejects over-budget "
                         "tenants with EnergyBudgetExceeded + retry_after")
    ap.add_argument("--joule-burst", type=float, default=50.0,
                    help="per-tenant joule budget bucket depth, joules "
                         "(only meaningful with --joule-rate)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text on this port for the run "
                         "(GET /metrics; also /snapshot, /trace, /healthz; "
                         "0 binds an ephemeral port and prints it)")
    ap.add_argument("--trace-dump", default=None,
                    help="write every recorded span as Chrome trace-event "
                         "JSON to this path at exit (open in Perfetto or "
                         "chrome://tracing)")
    ap.add_argument("--resume", action="store_true",
                    help="complete SUSPENDED batches from a previous run")
    ap.add_argument("--recover", action="store_true",
                    help="full restart path: resume SUSPENDED batches AND "
                         "replay admitted-but-unbatched requests from the "
                         "write-ahead admission log (admitted means "
                         "durable; implies --resume)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="run N worker processes behind the consistent-"
                         "hash FleetRouter instead of one in-process "
                         "service (each worker gets its own workdir + WAL "
                         "under --workdir and, on the card, its own CUDA "
                         "context; 0 = single-process mode)")
    ap.add_argument("--router-port", type=int, default=None,
                    help="with --fleet: serve the fleet-level Prometheus "
                         "exposition (repro_fleet_* with a worker label; "
                         "also /snapshot and cross-worker /trace) on this "
                         "port; 0 binds an ephemeral port and prints it")
    ap.add_argument("--standby", default=None, metavar="HOST:PORT",
                    help="ship the write-ahead admission log to a warm "
                         "StandbyReplica listening at this address for the "
                         "whole run, so a lost workdir can be promoted "
                         "without losing an admitted request "
                         "(single-process mode)")
    ap.add_argument("--reload", default=None, metavar="JSON",
                    help="apply a live config reload before driving load: "
                         "a JSON object of reloadable knobs, e.g. "
                         "'{\"tenant_rate\": 50}' — fanned to every "
                         "worker's POST /reload with --fleet, applied "
                         "in-process otherwise; the bumped config epoch "
                         "is printed and stamped into traces and metrics")
    ap.add_argument("--rolling-restart", action="store_true",
                    help="with --fleet: after the workload drains, restart "
                         "every worker one at a time (drain, respawn over "
                         "the same workdir, re-pin the router) and drive a "
                         "verification batch — the zero-downtime upgrade "
                         "path")
    return ap


def run_fleet(args, workdir: str) -> dict:
    """--fleet N: the same workload through N worker processes behind the
    consistent-hash router, then the fleet scorecard; returns the request
    failure counts."""
    from repro_torch.service.fleet import FleetRouter, WorkerManager

    worker_config = {
        "device": args.device,
        "max_batch": args.max_batch,
        "max_wait_s": args.max_wait_ms / 1000.0,
        "continuous": not args.no_continuous,
        "join_window_s": args.join_window,
        "bucket_policy": args.bucket_policy,
    }
    if args.power_cap is not None:
        worker_config["power_cap_watts"] = args.power_cap
    if args.joule_rate is not None:
        worker_config["tenant_joule_rate"] = args.joule_rate
        worker_config["tenant_joule_burst"] = args.joule_burst
    if args.warm_start is not None:
        worker_config["warm_start"] = json.loads(args.warm_start)
    if args.device_budget_mb is not None:
        worker_config["device_budget_bytes"] = args.device_budget_mb * 2**20
    manager = WorkerManager(workdir, args.fleet,
                            worker_config=worker_config)
    manager.start()
    router = FleetRouter(manager)
    exporter = None
    try:
        if args.router_port is not None:
            exporter = router.serve_metrics(args.router_port)
            print(f"# fleet telemetry: "
                  f"http://127.0.0.1:{exporter.port}/metrics")
        if args.reload:
            changes = json.loads(args.reload)
            result = router.reload(changes)
            print(f"# reload: epochs {result['epochs']}, "
                  f"converged {result['converged']}, "
                  f"errors {result['errors']}")
        workload = build_workload(
            args.requests, args.tenants, args.algo,
            features=args.features, clusters=args.clusters,
            points=args.points)
        executor = None if args.executor == "auto" else args.executor
        failures = drive(router, workload, args.rate, executor,
                         ttl=args.ttl)
        if args.rolling_restart:
            manager.rolling_restart()
            for r in manager.restarts:
                print(f"# rolling restart: {r['worker']} "
                      f"pid {r['old_pid']} -> {r['new_pid']} "
                      f"in {r['duration_s']:.2f}s")
            # the upgraded fleet must still serve
            verify = build_workload(min(args.requests, 8), args.tenants,
                                    args.algo, features=args.features,
                                    clusters=args.clusters,
                                    points=args.points, seed=1)
            post = drive(router, verify, args.rate, executor, ttl=args.ttl)
            print(f"# rolling restart: post-restart batch failures {post}")
        snap = router.metrics_snapshot()
        fleet = snap["fleet"]
        print(json.dumps(fleet, indent=2, default=str))
        per_worker = {
            name: (ws.get("totals") or {}).get("requests", 0)
            for name, ws in snap["workers"].items()}
        print(f"# fleet: {fleet['alive']}/{fleet['n_workers']} workers "
              f"alive, requests per worker {per_worker}, "
              f"router {fleet['router']['submitted']} submitted / "
              f"{fleet['router']['retries']} retries / "
              f"{fleet['router']['spills']} bounded-load spills, "
              f"failures {failures}")
    finally:
        if exporter is not None:
            exporter.stop()
        router.close()
        manager.stop()
    return failures


def main(argv: Optional[List[str]] = None) -> None:
    """The CLI entry point (``repro-torch-serve-mine``)."""
    run(argv)


def run(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv``, drive the workload, print the scorecard; returns the
    request failure counts."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.standby and args.fleet:
        parser.error("--standby is single-process mode only: each fleet "
                     "worker needs its own standby (see "
                     "WorkerManager(standbys=...))")
    if args.rolling_restart and not args.fleet:
        parser.error("--rolling-restart needs --fleet N (the in-process "
                     "equivalent is ClusteringService.handover())")
    workdir = args.workdir
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="repro_serve_mine_")
        print(f"# workdir: {workdir}")
    if args.fleet:
        return run_fleet(args, workdir)
    backend_mod.load(args.device)
    warm_start = (json.loads(args.warm_start)
                  if args.warm_start is not None else None)
    service = ClusteringService(
        workdir,
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0,
        continuous=not args.no_continuous,
        join_window_s=args.join_window,
        warm_start=warm_start,
        bucket_policy=args.bucket_policy,
        device_budget_bytes=(None if args.device_budget_mb is None
                             else args.device_budget_mb * 2**20),
        power_cap_watts=args.power_cap,
        tenant_joule_rate=args.joule_rate,
        tenant_joule_burst=args.joule_burst,
        device=args.device,
    )
    client = MiningClient(service=service)
    shipper = None
    if args.standby:
        from repro_torch.service.replicate import WalShipper

        s_host, _, s_port = args.standby.rpartition(":")
        shipper = WalShipper(service.wal, s_host or "127.0.0.1",
                             int(s_port)).start()
        service.attach_replicator(shipper)
        print(f"# replicating WAL to standby {args.standby}")
    exporter = None
    if args.metrics_port is not None:
        exporter = TelemetryServer(service.metrics_snapshot,
                                   tracer=service.tracer,
                                   port=args.metrics_port).start()
        print(f"# telemetry: http://127.0.0.1:{exporter.port}/metrics")
    if args.resume and not args.recover:
        outcomes = client.resume_suspended()
        for o in outcomes:
            print(f"resumed job {o.job_id}: {o.algo} x{o.size} "
                  f"on {o.executor} in {o.exec_s:.3f}s")
        if not outcomes:
            print("nothing to resume")

    workload = build_workload(
        args.requests, args.tenants, args.algo,
        features=args.features, clusters=args.clusters, points=args.points)
    executor = None if args.executor == "auto" else args.executor
    # SIGTERM/SIGINT -> cooperative preemption: in-flight batches
    # checkpoint and park SUSPENDED (finish later with --resume)
    with PreemptionGuard(service.token), service:
        if args.recover:
            # resume suspended batches, then replay every admitted request
            # the dead process never batched (the WAL's lose-nothing path)
            summary = client.recover()
            for o in summary["outcomes"]:
                print(f"resumed job {o.job_id}: {o.algo} x{o.size} "
                      f"on {o.executor} in {o.exec_s:.3f}s")
            print(f"recovered: {summary['resumed_batches']} suspended "
                  f"batch(es), {summary['replayed']} replayed request(s) "
                  f"({summary['cache_hits']} cache hits, "
                  f"{summary['rejected']} rejected)")
            for h in summary["requests"]:
                try:
                    h.result(300)
                except Exception as e:
                    print(f"replayed request {h.request_id} failed: {e!r}")
        if args.reload:
            cfg = service.apply_config(json.loads(args.reload))
            print(f"# reload: epoch {cfg.epoch} applied")
        failures = drive(client, workload, args.rate, executor, ttl=args.ttl)
    if shipper is not None:
        shipper.stop(final_ship=True)
        st = shipper.stats()
        print(f"# standby: {st['bytes_shipped']} bytes shipped in "
              f"{st['chunks_shipped']} chunks, "
              f"lag {st['standby_lag_entries']} entries, "
              f"{st['ship_errors']} ship errors")
    if exporter is not None:
        exporter.stop()
    if args.trace_dump:
        with open(args.trace_dump, "w") as fh:
            json.dump(chrome_trace(service.export_trace()), fh)
        print(f"# trace dump: {args.trace_dump}")
    snap = client.metrics()
    print(json.dumps(snap, indent=2, default=str))
    lanes = {name: f"{st['busy_s']:.3f}s/{st['batches']}b"
             for name, st in snap["lanes"].items() if st["batches"]}
    bkt = snap["bucketing"]
    print(f"# {snap['requests']} requests, "
          f"p50 {snap['p50_latency_s'] * 1e3:.1f}ms / "
          f"p99 {snap['p99_latency_s'] * 1e3:.1f}ms, "
          f"occupancy {snap['mean_occupancy']:.2f}, "
          f"lanes {lanes}, failures {failures}")
    print(f"# bucketing [{bkt['policy']['name']}]: "
          f"padding waste {bkt['padding_waste']:.2%}, "
          f"{bkt['recompiles']} distinct step shape(s)")
    energy = snap.get("energy") or {}
    cap = energy.get("cap") or {}
    by_class = {name: f"{tot.get('modeled_joules', 0.0):.2f}J/"
                      f"{tot.get('batches', 0)}b"
                for name, tot in sorted((energy.get("by_class")
                                         or {}).items())}
    cap_note = (f", cap {energy['power_cap_watts']:g}W "
                f"(throttled {cap.get('throttled_s_total', 0.0):.2f}s "
                f"over {cap.get('throttles', 0)} batch(es))"
                if energy.get("power_cap_watts") is not None else "")
    budget = energy.get("budget") or {}
    budget_note = (f", budget rejections {budget.get('rejections', 0)}"
                   if budget.get("tenant_joule_rate") is not None else "")
    print(f"# energy: {energy.get('joules_total', 0.0):.2f}J total, "
          f"{energy.get('joules_per_point', 0.0) * 1e3:.3f}mJ/point, "
          f"classes {by_class}{cap_note}{budget_note}")
    slo = snap["slo"]
    print(f"# slo: {'OK' if slo['ok'] else 'VIOLATED'} — "
          f"p{slo['latency_percentile']:g} "
          f"{slo['observed_latency_s'] * 1e3:.1f}ms vs "
          f"{slo['latency_target_s'] * 1e3:.0f}ms target "
          f"(burn {slo['latency_burn_rate']:.2f}), "
          f"error rate {slo['observed_error_rate']:.3f} vs "
          f"{slo['error_rate_target']:.3f} "
          f"(burn {slo['errors_burn_rate']:.2f})")
    return failures


if __name__ == "__main__":
    main()
