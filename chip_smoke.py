#!/usr/bin/env python3
"""Drive the PyTorch port's mining, LM serving and LM training paths, the
serving and training of every LM family, its tour examples, the
pod-scale K-Means cell, the GPipe pipeline and the dry-run on one CUDA
card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``.  It imports nothing of JAX or of the reference package.

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   reports the build time and each kernel's registers.
2. Holds every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: assignment at n = 2^20, d = 32, k = 64
   (indices exact, distances within 2e-4); the fused masked Lloyd step at
   the same shape with the last 25% of rows masked, and at k = 1024,
   n = 65536 (indices equal to the plain version's and to the assignment
   kernel's, counts exact, sums and inertia within 1e-4 relative, two
   launches bitwise equal); the one-job step's narrow-row sums at the
   kmeans-d4 cell's n = 2^24, d = 4, k = 8 and at quickstart's n = 6144,
   d = 2, k = 6 (bit for bit its plain model, counts exact, within
   fp32 rounding of the float64 sums, two launches bitwise equal; timed
   beside the model and the one-hot product it replaced, its launches
   those of quickstart and mine_cluster); eps-degree and expansion with a
   ~5% frontier at the one-job path's n = 65536 (d = 4, eps = 2), at the
   service's shape (its first DBSCAN request padded to the bucket,
   n = 16384, with the far-diagonal pads) and at n = 2048: both equal to
   the plain versions (torch.equal), two launches bitwise equal, each
   timed beside
   its plain version and a composed cdist yardstick, the exact rechecks
   per pair scored, the host time a call and (profiler) the device time
   a call logged; the cross entries (rows of one shard against the
   columns of another, the distributed lane's ring step) at the ring's
   shape: phase 4d's DBSCAN request padded to 131,072 rows and cut into 4
   shards of 32,768, rows and columns the last shard (its far-diagonal
   pads included), a ~5% frontier, each equal to its plain twin, timed
   beside it and a composed cdist yardstick, with the rechecks per pair
   scored at every (rows, columns) pair of the ring; flash
   attention at OLMo-1B's prefill shape (B 4, S 4096, 16 heads of 128,
   bf16, causal), GLM4-9B's (B 1, S 4096, 32 heads on 2 KV heads) and
   MiniCPM-2B's width (B 2, S 2048, 36 heads of 64), three more (odd
   length with GQA, full attention at D 96 in fp32, a narrow head), and
   phase 3e's seven other prefill shapes (B 2, S 2048: InternVL2-26B, 48
   heads on 8 KV heads of 128; MusicGen-medium, 24 heads padded to 32 of
   64; OLMoE-1B-7B, 16 heads of 128; Phi3.5-MoE and Jamba, 32 heads on 8
   KV heads of 128; Phi3-mini-3.8B, 32 heads of 96; MiniCPM-2B, 36 heads
   padded to 48 of 64; GLM4-9B, 32 heads on 2 KV heads of 128; each a row
   of the kernels line with its plain and SDPA times), within 2e-4
   (fp32) / 3e-2 (bf16) of the plain version elementwise and within
   1e-4 / 1e-2 of its norm in every 128-row query block of a head (against
   the plain version in fp32), two launches bitwise equal;
   every bf16 row must take the tensor-core route ("tc",
   ``csrc/flash_sm90.cu``) and every fp32 row the CUDA-core one ("simt",
   ``csrc/attention.cu``).  Times kernel, plain version and a PyTorch
   yardstick (``library_ms``, never called by the port; SDPA for
   attention), and the "simt" kernel on the OLMo-1B and Phi3-mini rows'
   bf16 inputs beside the "tc" one, held to the same two bounds ("tc" at
   D 96 at least 10x faster than "simt").  The build step logs
   the ``HGMMA``, ``HMMA`` and ``UTMALDG`` instructions in the SASS of the
   flash, assignment, fused and neighbour libraries and fails without
   tensor-core instructions (``HGMMA`` for flash and the neighbour
   kernels).  The assignment and fused kernels are
   also held to their plain versions at near-ties (points at the midpoints
   of centroid pairs and 1 ulp either side, duplicate centroids, points on
   centroids, an inf row and a NaN row) at d = 32 and d = 5: indices and
   scores bit for bit; at d = 96, 128, 192 and 1024 (either side of the
   switch to the wide search at d > 96) and at the embedding fit's n =
   1,024, d = 2,048, k = 4, bit for bit, each timed with both search forms
   where they fit; and the exact rechecks per point (mean and most) are
   logged at every shape.
3. Slice 1's path, the one-job app, at full width through
   ``run_mining_job``: K-Means on 1,048,576 points of 32 features with 64
   clusters, and DBSCAN on 65,536 points of 4 features, each against its
   plain run (DBSCAN labels equal, K-Means step-1 assignment equal and
   final inertia within 1e-4 relative).
3b. Slice 2's path, the clustering service's kernel lane, through
   ``serve_mine.build_workload`` + ``drive`` on a
   ``ClusteringService(device="cuda")`` pinned to ``cuda-kernel``: 8
   K-Means requests of ~2^20 points (32 features, 64 clusters of
   15,360-16,384 points, so items pad and mask) and 8 DBSCAN requests of up
   to 16,384 points (4 features, 8 clusters), max_batch 4, continuous
   batching, the K-Means bucket warmed at start.  Every request resolves on
   ``cuda-kernel``; DBSCAN labels equal the plain ``dbscan.fit`` on the
   card; K-Means final inertia matches the same requests on ``torch-ref``
   within 1e-4 relative, and both lanes' cached steps give the same step-1
   assignment on a padded item.  Then one K-Means batch of new requests
   runs on a service of its own under ``torch.profiler``: its device time,
   the fused step's share of it, and the lane's exec_s - host_s for the
   batch are logged.
3c. Slice 3's path, LM serving, through ``serve.serve_batch`` at OLMo-1B's
   full width (16 layers, d_model 2048, vocab 50304, synthetic bf16
   weights): batch 4, prompt 4096, 32 generated tokens.  The flash kernel
   must launch once per layer of the prefill (16), every launch on the
   "tc" route, and never in decode, and every logit must be finite.  Then,
   in fp32 at the same widths (batch 2, prompt 1024, 8 tokens), the kernel
   route ("simt", as fp32 goes) against the same run with the layers'
   attention patched to the plain version: prefill logits within
   1e-4 of the largest logit, greedy tokens equal.  The bf16 run's distance
   from the plain route is printed, not gated.
3d. Slice 9's path, LM training, with no step on the CPU except (c)'s
   host half.  (a) OLMo-1B at its published width and depth (16 layers,
   d_model 2048, 16 heads of 128, d_ff 8192, vocab 50,304; bf16 weights
   with fp32 master, mu and nu; remat "full"; wsd): 4 steps of
   ``train.step.make_train_step`` on one fixed batch of 16 x 2048 tokens
   (the config's loss_chunk=16 chunked CE).  Every loss finite, the loss
   lower at step 4 than at step 1, every parameter leaf's step-1 gradient
   finite and non-zero, and no flash launch in training (the training
   attention is ``layers._sdpa``).  Prints the median step time of steps
   2-4, tokens/s, MFU against 989 TFLOP/s with the step's FLOP count,
   peak memory and the card, and profiles one more step.  (b)
   ``launch.train.run_training_job`` at full width with the depth cut to 2
   layers: cancelled after step 2 (by step count), it must end SUSPENDED
   with an emergency checkpoint whose restore is bit-equal to the saved
   state (generator included); a second call claims the same job and ends
   at step 4; its losses agree with an uninterrupted run's within 1e-2
   relative.  Prints save and restore seconds and bytes written.  (c) The
   same 2-layer width in fp32 on the card and on the host, same params and
   tokens: every gradient leaf within 1e-3 of its largest |g| and the
   loss within 1e-4 relative; and a prefill of (a)'s trained weights
   launches flash "tc" once a layer.
3e. Slices 11 and 14's path, the MoE, Mamba, hybrid and stub-frontend
   families and the three other dense archs, run after phase 5: each of
   internvl2-26b, musicgen-medium, olmoe-1b-7b, phi3.5-moe-42b-a6.6b (24
   of its 32 layers), falcon-mamba-7b, jamba-v0.1-52b (16 of 32 layers:
   two of its four periods), phi3-mini-3.8b, glm4-9b and minicpm-2b at
   its published width with synthetic bf16 weights, batch 2, a 2048-token
   prompt and 16 greedy tokens, through ``serve.serve_batch`` (the two cut
   depths through ``lm.init_params`` + ``serve.generate`` on the cut
   config), one arch's weights freed before the next: one flash launch an
   attention layer of the prefill (48, 48, 16, 24, 0, 2, 32 at D 96, 40
   and 40), every one on "tc", none in decode, no mining kernel; logits
   finite, tokens in the
   vocabulary; prefill_s, ms per decode token and peak memory printed,
   with a profiler window over one more prefill and 4 decode steps, and
   for MoE the share of router choices dropped at capacity in a prefill,
   with each MoE layer's drop share, the mean pairwise cosine of its
   router inputs within a dispatch group and its top-1 expert histogram
   (printed, not gated).  internvl2 and musicgen also prefill with their
   stub frontend's ``synthetic_prefix`` (256 / 64 rows ahead of the rest
   of the 2048) and decode 4 tokens after it, with the same checks.
   Then card against host, fp32, batch 2, prompt 256, 4 greedy tokens:
   each family at its published width cut to one layer group (jamba at
   its smoke config, one whole period: a period at full width is 51 GB in
   fp32), the same weights and prompts: prefill logits within 1e-4 of the
   largest |logit|, greedy tokens equal, and every MoE layer's router ids
   and keep mask equal (a flip prints the nearest tie's gap).
3f. Slices 13 and 14's path, the same nine archs trained on the card, run
   after 3e, one arch's state freed before the next.  (a) 3d's training at
   published width (bf16, fp32 master / mu / nu, remat "full", wsd, 4
   steps at lr 1e-5, the MoE archs at 3e-6 (``FAMILY_LR``), on one fixed
   batch, the stub frontends' prefix rows from ``make_train_batch``):
   musicgen-medium at all 48 layers, 16 x 2048; olmoe-1b-7b at 7 of 16
   layers (what 80 GB holds) and falcon-mamba-7b at 2 of 64 (a step at
   20 layers takes 43 s), 8 x 2048; internvl2-26b at 4 of 48, 4 x 2048;
   phi3.5-moe at 2 of 32, 8 x 2048; jamba at its smoke config (one
   period, narrow widths, the published Mamba chunk), 8 x 2048;
   minicpm-2b at all 40 layers, 4 x 2048; phi3-mini-3.8b at 28 of 32
   layers, 4 x 2048; glm4-9b at 11 of 40 layers, 2 x 2048 (what 80 GB
   holds, from the meta-device trace).  Each logs its state
   reckoned at 16 B a parameter, then losses (ce and the MoE aux apart),
   the median step time of steps 2-4, tokens/s, MFU (6 x the active
   parameters a token, attention only for attention layers; the Mamba
   scan's element-wise work not counted), peak memory, each MoE layer's
   drop share at capacity 1.25 over the batch, and a profiler window over
   one more step (device only, as every window).  Every loss finite, step
   4's below step 1's, no kernel launched in training.  (e) A prefill of
   the trained olmoe-1b-7b, musicgen-medium and phi3-mini-3.8b weights (2 x
   2048 positions, musicgen's 64 prefix rows among them) launches flash
   "tc" once per attention layer (phi3-mini's at D 96), logits finite.
   (b) Each family at published width cut to one layer group
   (jamba at its smoke config; one layer for a dense arch: minicpm-2b's
   tied head, glm4-9b's GQA 16:1) and OLMo-1B at 3d's 2 layers, bf16,
   batch 2 x 2048: the step-1 loss and gradients computed twice are equal
   bit for bit, every leaf finite and non-zero.  (c) The same cuts in fp32,
   batch 2 x 256, card against host: every MoE call's router ids and keep
   masks equal (a flip prints the nearest tie's gap), then every gradient
   leaf within 1e-3 of its largest |g| and the loss within 1e-4 relative.
   (d) ``run_training_job`` for olmoe-1b-7b and falcon-mamba-7b at their
   smoke configs' widths (the machine takes 45 GiB of disk writes a run;
   at published width the checkpoints alone were 50 GB), 2 x 256:
   cancelled after step 2, SUSPENDED, the emergency checkpoint's restore
   bit-equal, resumed by a second call to step 4, losses within 1e-2 of
   the same steps run in one loop; save and restore seconds and bytes
   printed; then each smoke config in bf16 after a step through the store
   and ``restore_train_state`` on the card, bit-equal, falcon-mamba's
   float32 ``a_log`` / ``dt_bias`` float32 in the params and masters.
4. Checks small runs against the sequential DBSCAN oracle, that a
   cancelled job ends SUSPENDED, and (4b) that a service batch preempted
   mid-run on the card ends SUSPENDED and resumes in a fresh service to the
   uninterrupted labels.
4c. Slice 7's path, the durable serving tier, at the service phase's
   widths, every worker a process of its own with its own CUDA context on
   the one card (spawned after the build, so each loads the built
   libraries).  First an uninterrupted single-process card service labels
   5 K-Means requests of ~2^20 points and 1 DBSCAN request of ~16K points
   on ``cuda-kernel``.  Fleet failover: a ``WorkerManager`` of 3 workers
   behind a ``FleetRouter``; worker-0 admits but never batches, 3 K-Means
   requests are durably admitted there (the ACK is its WAL fsync), 2
   K-Means and 1 DBSCAN request go live to the survivors, and worker-0 is
   SIGKILLed with them in flight.  No admitted request may be lost, labels
   must equal the single-process ones per content hash, every result must
   come from ``cuda-kernel``, the victim's tenants must re-place, its WAL
   must drain to zero pending and the fleet ``/metrics`` exposition must
   validate; spawn, admission and failover times and the survivors' kernel
   launches (read from their ``/snapshot`` before and after) are printed.
   Standby: a primary worker on the card durably admits 4 of those K-Means
   requests while its ``WalShipper`` mirrors the WAL to a
   ``StandbyReplica`` here; at zero lag the primary is SIGKILLed, the
   replica's exposition must validate, and ``promote(device="cuda")``
   must replay all 4 to the same labels and take a live reload at epoch 1.
   Rolling restart: a 2-worker card fleet holding the 4 requests durably
   is restarted worker by worker; labels stay equal, every pid changes, a
   fleet-wide reload converges on one epoch before and after, and a new
   request after the roll launches the fused kernel.  The card's peak
   memory (every process on it) is printed for each.
4d. Slice 8's path, the distributed lane, on the card with no fallback:
   (a) a DBSCAN request of 100,000 points (4 features, 8 clusters, eps 2,
   min_pts 40) at the default budget is routed to ``distributed`` with no
   flag (its 131,072-row bucket is over budget) and its labels equal the
   one-job ``dbscan`` fit on the card of the same padded points (1 cross
   degree launch, 1 cross expansion a BFS step); (b) the same points
   through ``sharded_dbscan_fit_resumable`` on 4 shards of the card: the
   same labels, 16 cross launches a ring call; (c) a K-Means request of
   2^20 points (32 features, 64 clusters, ``max_iters`` 50) routed there
   by a 256 MiB budget, at 1 and 4 shards: labels and iterations equal to
   the ``cuda-kernel`` lane's (the shards are cut at the fused step's
   blocks, so its partials and their reduction are the one launch's), one
   fused pass-1 launch a shard and one pass-2 launch a Lloyd iteration; (d) both requests preempted mid-shard at 4 shards and
   resumed at 1 to the same labels.  Each run's wall (profiler on),
   device busy share and launches are printed.
5. Slice 10's path, the four tour examples (``repro_torch.examples``) on
   the card, run after 3d: (a) ``quickstart.main`` and ``mine_cluster.main``
   (the 3 x 2 job grid, the 50 ms cancel, the job store read back): K-Means
   labels and iterations, DBSCAN labels, clusters and expansions equal to
   the same calls with the plain versions, one assignment launch an
   iteration, one degree launch and one expansion launch an expansion a
   DBSCAN fit; (b) ``service_demo.run``: every handle resolved, the cache
   hit, the dropped stream reopened with bit-equal centroids, the preempted
   batch resumed (or the "finished first" branch), acts 1-3 on the
   ``numpy-mt`` host lane by the small-work rule and act 4 on ``torch-ref``
   (so the demo launches no kernel, as in the reference); then
   the reopened stream's ``assign`` on the card (one assignment launch)
   equal to ``assign_clusters_ref``; (c) embedding clustering through the
   example's functions at OLMo-1B's published width and depth (bf16,
   1,024 documents x 128 tokens): 16 flash launches, all "tc", finite
   logits, the forward's time and peak memory (and one more forward
   under ``torch.profiler``); the pooled (1024, 2048)
   fp32 points clustered with k-means++ at k = 4, one assignment launch an
   iteration (the wide search), labels and iterations equal to the plain
   versions; (d) the assignment kernel at that shape and the fit's first
   centroids, indices and distances bit-equal to the plain version, timed
   beside it and ``cdist`` (a row of its own in the kernels line).
6. Slice 12's path, run last: (a) the reference's pod-scale K-Means cell
   (``launch/dryrun_cluster.py``'s shape: 2^24 x 128 fp32 points of
   ``make_blobs`` with 4,096 centres, drawn on the card, and 4,096 of them
   as centroids) through ``core.distributed.clustering_step_for_dryrun``
   on meshes repeating the card, 2 shards then 16 (one fused launch takes
   n d < 2^31 only): pass-1 and pass-2 launches counted, the two results
   bitwise equal, the assignments equal to the plain step's (the
   ``use_kernel=False`` branch on 16 shards), counts exact, new centroids
   within 1e-4 of the largest |x|, shift and inertia within 1e-4
   relative; pass 1 over each 2-shard shard and pass 2 timed by events
   (the kernels line's ``fused_masked_partials_pod`` row, pass 1 over the
   first shard held to its plain version: indices and counts equal, sums
   within 1e-4 of count x largest |x|), the step walls, the peak memory,
   and the dry-run's inventory of the step on a one-device mesh beside
   it; (b) GPipe on the card: OLMo-1B's 16 layers in 4 stages on
   ``Mesh((cuda:0,) * 4, axis="pipe")``, bf16, 4 microbatches of 1 x 2048
   under no_grad, the hidden states equal (``torch.equal``) to
   ``hidden_forward`` per microbatch with 64 more "tc" flash launches;
   then 4 one-layer stages at that width in fp32 under autograd, every
   gradient leaf within 1e-4 of its largest |g| of the unpipelined
   loss's; (c) the dry-run held to the card: phase 3d's OLMo-1B train
   cell traced on a one-device mesh, its state's argument bytes equal to
   what 3d allocated (within 512 bytes a tensor), argument + temp bytes
   within 2x of 3d's peak, its FLOPs beside ``train_flops``; and
   ``launch.dryrun`` on the single pod for olmo-1b train_4k, olmoe-1b-7b
   train_4k, jamba prefill_32k, internvl2-26b decode_32k and
   falcon-mamba-7b long_500k (processes of their own on the host, started
   before (a) and read after (b)), each record's argument GB and FLOPs
   logged.
7. Launch counters are zeroed just before each path and read just after;
   every kernel of a path must have launched in it.  Prints one ``kernels``
   JSON line and, last, the device line.  Any failed check exits non-zero
   before that line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12      # FLOP/s
PEAK_BF16 = 989e12     # FLOP/s, dense tensor cores
PEAK_TF32 = 495e12     # FLOP/s, dense tensor cores
PEAK_BYTES = 3.35e12   # byte/s

ASSIGN_SHAPE = dict(features=32, clusters=64, size=16384)   # n = 2^20
DBSCAN_SHAPE = dict(features=4, clusters=8, size=8192)      # n = 65536
FRONTIER_FRACTION = 0.05
FUSED_MASKED_FRACTION = 0.25
# The one-job step's narrow-row sums at the shapes its paths give it: the
# kmeans-d4 benchmark cell's 2^24 rows of 4 features with k = 8, and
# quickstart's 6,144 rows of 2 features with k = 6.
LLOYD_SHAPES = (dict(features=4, clusters=8, size=1 << 21),
                dict(features=2, clusters=6, size=1024))
FUSED_LARGE_K = dict(n=65536, k=1024)
# Both K-Means kernels either side of the plan's choice of search form
# (d > 96 is wide), at a common embedding width, and at the embedding
# fit's small n (its k = 4 takes the wide search's exact form): (n, k, d).
SEARCH_WIDTHS = [(65536, 64, 96), (65536, 64, 128), (65536, 64, 192),
                 (16384, 64, 1024), (1024, 4, 2048)]
SEED = 0
# Where every phase runs: the card.
DEV = "cuda"

# The service phase: the paper's widest DBSCAN tuple, and K-Means items of
# about 2^20 points each, unequal so the bucket pads and masks rows.
SVC_KMEANS = dict(features=32, clusters=64, points=16384, min_points=15360)
SVC_DBSCAN = dict(features=4, clusters=8, points=2048, min_points=1792)
SVC_REQUESTS = 8
SVC_MAX_BATCH = 4
# The fleet phases, at the service phase's widths: a 3-worker fleet on the
# card (3 durable K-Means requests on the victim, 2 K-Means + 1 DBSCAN live
# on the survivors), then a standby promoted from a SIGKILLed primary of
# 4 durable K-Means requests, and a 2-worker fleet rolled under them.
FLEET_WORKERS = 3
FLEET_VICTIM = "worker-0"
FLEET_VICTIM_REQUESTS = 3
FLEET_LIVE_KMEANS = 2
FLEET_LIVE_DBSCAN = 1
FLEET_LIVE = dict(max_batch=4, max_wait_s=0.005)
FLEET_ADMIT_ONLY = dict(max_batch=64, max_wait_s=3600.0)
# How long a fleet worker may answer no heartbeat before it is killed.  At
# 6 x the 0.25 s interval (1.5 s), both workers of the roll were killed
# while they admitted ~124 MiB durable requests, live; these phases check
# labels, not detection under load, and a killed worker is found by its
# exit, not by this deadline.
FLEET_MISS_DEADLINE = 30.0
STANDBY_REQUESTS = 4
ROLL_WORKERS = 2
# The preemption phase: a K-Means batch that runs its full iteration count
# (tol 0), long enough to be cancelled mid-run.
PREEMPT_KMEANS = dict(features=32, clusters=64, points=4096)
PREEMPT_ITERS = 1000
# The distributed lane (phase 4d): a DBSCAN request at the dbscan-64K job's
# parameters and 100,000 points, whose 131,072-row bucket is over the
# default budget (4 n^2 bytes) so it rides the lane with no flag; a
# K-Means request of the service-kmeans-1M shape, routed there by a 256 MiB
# budget (its estimate at 2^20 rows is 528 MiB); meshes of 1 shard (the one
# card) and of 4 shards repeating it.
DIST_DBSCAN = dict(features=4, clusters=8, points=12500)
DIST_KMEANS = dict(features=32, clusters=64, points=16384)
DIST_KMEANS_BUDGET = 256 * 2**20
DIST_SHARDS = 4

# Flash attention on the card: (what, B, S, H, KV, D, dtype, causal).  The
# first is OLMo-1B's prefill at the serving shape; the row's timing is there.
ATTN_SHAPES = [
    ("OLMo-1B prefill", 4, 4096, 16, 16, 128, "bfloat16", True),
    ("GLM4-9B prefill", 1, 4096, 32, 2, 128, "bfloat16", True),
    ("MiniCPM-2B width", 2, 2048, 36, 36, 64, "bfloat16", True),
    ("odd length, GQA", 2, 1000, 32, 2, 128, "float32", True),
    ("full attention", 1, 517, 12, 12, 96, "float32", False),
    ("narrow head", 2, 300, 8, 8, 64, "bfloat16", True),
    ("InternVL2-26B prefill", 2, 2048, 48, 8, 128, "bfloat16", True),
    ("MusicGen-medium prefill", 2, 2048, 32, 32, 64, "bfloat16", True),
    ("OLMoE-1B-7B prefill", 2, 2048, 16, 16, 128, "bfloat16", True),
    ("Phi3.5-MoE / Jamba prefill", 2, 2048, 32, 8, 128, "bfloat16", True),
    ("Phi3-mini-3.8B prefill", 2, 2048, 32, 32, 96, "bfloat16", True),
    ("MiniCPM-2B prefill", 2, 2048, 48, 48, 64, "bfloat16", True),
    ("GLM4-9B served prefill", 2, 2048, 32, 2, 128, "bfloat16", True),
]
# the rows of the kernels line besides OLMo-1B's: every other prefill shape
# of phase 3e (musicgen's 24 heads padded to 32 and minicpm's 36 to 48,
# their KV heads with them, the padded heads masked after the kernel;
# phi3.5-moe and jamba share GQA 32/8; falcon-mamba has no attention)
ATTN_ROWS = {"InternVL2-26B prefill": "flash_attention_internvl2",
             "MusicGen-medium prefill": "flash_attention_musicgen",
             "OLMoE-1B-7B prefill": "flash_attention_olmoe",
             "Phi3.5-MoE / Jamba prefill": "flash_attention_gqa32_8",
             "Phi3-mini-3.8B prefill": "flash_attention_phi3",
             "MiniCPM-2B prefill": "flash_attention_minicpm",
             "GLM4-9B served prefill": "flash_attention_glm4"}
# rows that also run the "simt" kernel on their bf16 inputs (OLMo-1B's,
# the first, always does): phi3-mini's head width of 96 took "simt" before
# "tc" had it, so "tc" must be at least ATTN_SIMT_SPEEDUP x faster there
ATTN_SIMT = ("Phi3-mini-3.8B prefill",)
ATTN_SIMT_SPEEDUP = 10.0
# the reference's own flash-test tolerances (tests/test_parallel.py)
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# and per 128-row query block of one (b, h), the relative Frobenius error
# against the plain version in fp32 (ref.block_error): what the elementwise
# bound lets through at long rows, where outputs are ~0.03
ATTN_BLOCK_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# which kernel each dtype's rows must take (kernels/attention/ops._route)
ATTN_ROUTE = {"float32": "simt", "bfloat16": "tc"}
# The LM serving phase: OLMo-1B at full width, and the fp32 check's shape.
SERVE = dict(arch="olmo-1b", batch=4, prompt_len=4096, gen=32)
SERVE_CHECK = dict(batch=2, prompt_len=1024, gen=8)
SERVE_LOGIT_RTOL = 1e-4
# Phase 3e: the other nine archs at their published widths, bf16, synthetic
# weights, batch 2, a 2048-token prompt, 16 greedy tokens; depth as the
# reference's n_params() lets 80 GB hold it (None: every layer).
# phi3.5-moe is 2.6 GB a layer (83.7 GB whole): 24 of 32 layers.  jamba is
# 25.5 GB a period of 8 layers (103 GB whole): 2 of 4 periods.  The three
# dense archs at full depth: phi3-mini-3.8b (7.6 GB, heads of 96),
# glm4-9b (18.8 GB, 32 heads on 2 KV heads), minicpm-2b (~6 GB, 36 heads
# padded to 48, tied embeddings).
SERVE_FAMILIES = [
    ("internvl2-26b", None),
    ("musicgen-medium", None),
    ("olmoe-1b-7b", None),
    ("phi3.5-moe-42b-a6.6b", 24),
    ("falcon-mamba-7b", None),
    ("jamba-v0.1-52b", 16),
    ("phi3-mini-3.8b", None),
    ("glm4-9b", None),
    ("minicpm-2b", None),
]
SERVE_WIDE = dict(batch=2, prompt_len=2048, gen=16)
# the stub frontends' prefill: prefix_len rows + the rest of the 2048
SERVE_PREFIX_GEN = 4
# decode steps in each arch's profiler window
SERVE_PROFILE_STEPS = 4
# card against host, fp32, one layer group at the published width
SERVE_TWIN = dict(batch=2, prompt_len=256, gen=4)
# The training phase (3d): OLMo-1B at its published width and depth, bf16
# weights with fp32 master, mu and nu, remat "full", the wsd schedule;
# batch 16 x seq 2048 (OLMo's pretraining context; batch 16 engages the
# config's loss_chunk=16 chunked CE).  The lifecycle at full width with
# the depth cut to 2 layers (a 16-layer checkpoint is ~16.5 GB); the
# gradient check at full width, 2 layers, fp32, card against host.
TRAIN = dict(arch="olmo-1b", batch=16, seq=2048, steps=4)
# wsd over 4 steps warms up in one: the second step already takes the full
# lr, and AdamW's first update is ~lr x sign(g) on every weight.  At 1e-4
# (and the launcher's 1e-3) that overshoots at this depth and the loss rises
# over 4 steps, in bf16 and fp32 alike; 1e-5 falls
# (scripts/train_lr_sweep.py, PERF.md PR 19).
TRAIN_LR = 1e-5
TRAIN_CUT_LAYERS = 2
TRAIN_RESUME_RTOL = 1e-2
TRAIN_GRAD_CHECK = dict(batch=2, seq=256)
TRAIN_GRAD_TOL = 1e-3
# Phase 3f: the MoE, Mamba, hybrid and stub-frontend archs trained as 3d
# trains OLMo-1B (bf16, fp32 master / mu / nu, remat "full", wsd, 4 steps
# at TRAIN_LR on one fixed batch of seq TRAIN["seq"]): (arch, depth, batch),
# depth None for every layer, "smoke" for the smoke config (jamba: one
# period at narrow widths; one period at its published widths is 213 GB of
# state).  The depths are what 80 GB holds: the state is 16 B a parameter,
# and the meta-device trace of the step (launch/cells.py) puts argument +
# temp bytes at 74.2 GB for olmoe at 8 layers, which 3d's card peak (1.125
# x its trace) puts past 78 GB; at 7 layers the trace is 65.3 GB.
# falcon-mamba is cut by time: at 20 layers (65.25 GB on the card) a step
# took 42.8 s, the chunked doubling scan's element-wise passes under
# autograd (PERF.md), so it trains at 3d's cut of 2 layers.
# The three dense archs by the same rule (the trace's argument + temp
# bytes x 1.125 under 78 GB): minicpm-2b at all 40 layers, batch 4 (68.7
# GB; batch 6: 78.8); phi3-mini-3.8b at 28 of 32 layers, batch 4 (73.3;
# 30 layers: 78.3); glm4-9b at 11 of 40 layers, batch 2 (73.9; 12: 78.6),
# its untied embedding and head alone 1.24 B parameters (19.9 GB of state).
FAMILY_TRAIN = [("musicgen-medium", None, 16), ("olmoe-1b-7b", 7, 8),
                ("falcon-mamba-7b", 2, 8), ("internvl2-26b", 4, 4),
                ("phi3.5-moe-42b-a6.6b", 2, 8), ("jamba-v0.1-52b", "smoke", 8),
                ("minicpm-2b", None, 4), ("phi3-mini-3.8b", 28, 4),
                ("glm4-9b", 11, 2)]
# The MoE archs' loss rose from step 3 to 4 at 1e-5 (olmoe at 7 layers
# 11.4177, 11.4177, 11.0473, 12.2932; phi3.5-moe at 2 layers 10.9196,
# 10.9196, 10.5100, 11.5391) and at 3e-5; at 3e-6 it falls every step
# (11.4177, 11.4177, 11.3871, 11.2977; 10.9196, 10.9196, 10.8860, 10.7865),
# and at 1e-6 and 3e-7 by less (scripts/train_lr_sweep.py --arch; PERF.md).
# The others fall at TRAIN_LR.
FAMILY_LR = {"olmoe-1b-7b": 3e-6, "phi3.5-moe-42b-a6.6b": 3e-6}
# (e): the archs whose trained weights are prefilled (2 x TRAIN["seq"]);
# phi3-mini's on "tc" at D 96
FAMILY_SERVE = ("olmoe-1b-7b", "musicgen-medium", "phi3-mini-3.8b")
# (b): the step-1 gradients twice, each family at one layer group (jamba at
# its smoke config), and OLMo-1B at 3d's cut, bf16
TRAIN_BITS = dict(batch=2, seq=2048)
# (d): run_training_job at the smoke configs' widths.  The machine that
# runs the smoke takes 45 GiB of disk writes a run: at published width, 2
# layers, the two lifecycles' checkpoints were 50 GB (14.6 + 14.6 GB for
# olmoe, 10.4 + 10.4 for falcon-mamba; one checkpoint per layer was 8.8-
# 8.9 GB), and a run was ended at 47.6 GiB (PERF.md).  The smoke configs
# train in fp32, so a bf16 state of each is also saved and restored
# (train_restore_mixed).
FAMILY_LIFECYCLE = ("olmoe-1b-7b", "falcon-mamba-7b")
FAMILY_LIFECYCLE_JOB = dict(smoke=True, layers=None, batch=2, seq=256)
# the Mamba mixer's leaves that no matrix product reads (not in MFU's N)
MAMBA_ELEMENTWISE = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip")
# The examples phase (5): embedding clustering at OLMo-1B's published width
# and depth, 1,024 documents of 128 tokens (the forward's fp32 logits are
# 131,072 x 50,304 x 4 B = 26.4 GB), k = 4 with k-means++ seeding; the
# pooled points are d_model = 2048 wide, so the assignment kernel takes its
# wide search (d > ops.WIDE_D).
EMBED = dict(arch="olmo-1b", docs=1024, seq=128, k=4)
# Phase 6: the reference's pod-scale K-Means cell (its dryrun_cluster
# shape), x 8.6 GB of fp32, run as one step on meshes of 2 and 16 shards
# of the card (n d = 2^31 is one more than one fused launch takes); the
# plain step on 16 shards, whose (n / 16, k) score and one-hot matrices
# fit beside x.  New centroids within 1e-4 of the largest |x|, shift and
# inertia within 1e-4 relative.
POD = dict(n=1 << 24, d=128, k=4096)
POD_SHARDS = (2, 16)
POD_TOL = 1e-4
# GPipe on the card: OLMo-1B's 16 layers in 4 stages, 4 microbatches of
# 1 x 2048; the gradient check at 4 one-layer stages, fp32, 4 x (1 x 256)
PIPE = dict(arch="olmo-1b", stages=4, microbatches=4, batch=1, seq=2048)
PIPE_GRAD = dict(layers=4, batch=1, seq=256)
PIPE_GRAD_TOL = 1e-4
# The dry-run: one cell of each family on the single pod, and how far the
# OLMo-1B train cell's argument + temp bytes may stand from phase 3d's peak
DRYRUN_CELLS = (("olmo-1b", "train_4k"), ("olmoe-1b-7b", "train_4k"),
                ("jamba-v0.1-52b", "prefill_32k"),
                ("internvl2-26b", "decode_32k"),
                ("falcon-mamba-7b", "long_500k"))
DRYRUN_RATIO_LIMIT = 2.0
# PyTorch's caching allocator: blocks of up to 1 MiB are rounded to 512
# bytes; a larger block is split only when more than 1 MiB would remain
ALLOC_SMALL_ROUND = 511
ALLOC_SPLIT = 1 << 20
DRYRUN_TIMEOUT = 600


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound(bytes_moved: float, flops: float, peak: float = PEAK_FP32) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, the replays timed by CUDA events (the host's launch cost left
    out).  The captured calls count as launches: time before a path's
    counts are reset, or after they are read."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def host_us(torch, fn, reps: int = 50) -> float:
    """Host microseconds a call, the calls queued without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def timed_wall(torch, fn) -> float:
    """Host wall seconds of ``fn`` up to a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def spec_of(synth, shape: dict):
    return synth.ClusterSpec(shape["features"], shape["clusters"],
                             shape["size"])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# Tensor-core (wgmma: HGMMA, mma.sync: HMMA) and TMA instructions counted
# in each library's SASS, and those of which the build needs at least one.
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")
SASS_NEEDS = {"flash_sm90": ("HGMMA",), "distance": ("HGMMA", "HMMA"),
              "fused": ("HGMMA", "HMMA"), "neighbor": ("HGMMA",)}


def build(build_mod) -> dict:
    """Build every kernel; log registers and spills, and the tensor-core
    and TMA instruction counts of the libraries that use them (returned)."""
    t0 = time.time()
    build_mod.build_all()
    log(f"build: {time.time() - t0:.2f} s")
    for name in ("attention", "distance", "flash_sm90", "fused", "neighbor"):
        regs = sorted({ln.split(":", 1)[-1].strip()
                       for ln in build_mod.build_log(name).splitlines()
                       if "Used" in ln or "spill" in ln})
        log(f"ptxas {name}: {regs}")
    sass = {}
    for name, needs in SASS_NEEDS.items():
        out = subprocess.run(
            [build_mod.cuda_tool("cuobjdump"), "-sass",
             str(build_mod.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        sass[name] = {op: sum(ln.count(op) for ln in out.splitlines())
                      for op in SASS_OPS}
        log(f"SASS {name}: " + ", ".join(f"{v} {op}" for op, v in
                                         sass[name].items()) + " instructions")
        check(sum(sass[name][op] for op in needs) > 0,
              f"{name}: no {' or '.join(needs)} instruction in its SASS")
    return sass


def same_bits(torch, a, b) -> bool:
    """Equal bits, NaN matching NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32)))


def near_ties(torch, d: int, seed: int):
    """Points at the midpoints of centroid pairs and 1 ulp either side,
    duplicate centroids, points equal to a centroid, random points, a row
    holding inf and one holding NaN; and the centroids."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(56, d, generator=g) * 3
    c = torch.cat([c, c[:8]])
    mid = (c[:28] + c[28:56]) / 2
    inf = torch.full_like(mid, float("inf"))
    bad = torch.randn(2, d, generator=g)
    bad[0, d // 2] = float("inf")
    bad[1, 0] = float("nan")
    x = torch.cat([mid, torch.nextafter(mid, inf), torch.nextafter(mid, -inf),
                   c, torch.randn(4000, d, generator=g) * 3, bad])
    return x.contiguous().to(DEV), c.contiguous().to(DEV)


def search_line(dops, n, k, d, device) -> dict:
    """The wide search's plan at (n, k, d) and its grid on this card."""
    p = dops.plan(n, k, d)
    return dict(nt=p.nt, stages=p.stages, xres=p.xres,
                search_blocks=p.search_blocks,
                grid=dops.search_grid(p, dops.sm_count(device)))


def recheck_line(dops, fn, what, n) -> dict:
    total, most = dops.rechecks(fn)
    log(f"rechecks {what}: {total / n!r} per point (mean), {most} at most")
    return dict(mean=total / n, max=most)


def wide_rows(torch, mods) -> None:
    """Both K-Means kernels on each side of the plan's choice between the
    staged search (whole rows) and the wide one (d > ops.WIDE_D, the
    products streamed box by box), at SEARCH_WIDTHS: the assignment's
    indices and distances and the fused step's indices and counts equal to
    the plain version's bits, the fused sums within 1e-4 of their scale;
    each timed with the plan's search and with the other one where it fits
    (the staged search cannot hold rows of 1024 features)."""
    dops, fops, dref = mods["dops"], mods["fops"], mods["dref"]
    for n, k, d in SEARCH_WIDTHS:
        g = torch.Generator().manual_seed(SEED + d)
        c = torch.randn(k, d, generator=g) * 4
        x = c[torch.randint(0, k, (n,), generator=g)] + torch.randn(
            n, d, generator=g)
        x, c = x.to(DEV), c.to(DEV)
        mask = (torch.arange(n) % 4 != 1).to(DEV)
        p = dops.plan(n, k, d)
        idx, dist = dops.assign_clusters(x, c)
        ridx, rdist = dref.assign_clusters_ref(x, c)
        fidx, sums, counts, _ = fops.fused_masked_assign_update(x, c, mask)
        _, rsums, rcounts, _ = dref.fused_masked_assign_update_ref(x, c, mask)
        torch.cuda.synchronize()
        what = f"n={n} d={d} k={k} ({'wide' if p.wide else 'staged'})"
        check(bool(torch.equal(idx, ridx)) and same_bits(torch, dist, rdist),
              f"assignment {what}: differs from the plain version")
        scale = _member_abs_sums(torch, x, ridx, mask, k)
        check(bool(torch.equal(fidx, ridx))
              and bool(torch.equal(counts, rcounts))
              and bool(((sums - rsums).abs() <= 1e-4 * scale + 1e-6).all()),
              f"fused step {what}: differs from the plain version")
        times = {}
        wide_d = dops.WIDE_D
        for form, forced in (("staged", 1 << 30), ("wide", 0)):
            dops.WIDE_D = forced
            try:
                times[form] = (
                    time_ms(torch, lambda: dops.assign_clusters(x, c),
                            reps=10),
                    time_ms(torch, lambda: fops.fused_masked_assign_update(
                        x, c, mask), reps=10))
            except ValueError:  # no room in shared memory
                times[form] = None
            finally:
                dops.WIDE_D = wide_d
        recheck_line(dops, dops.assign_clusters, f"assignment {what}", n)
        log(f"search forms {what}: bit-identical to the plain version; "
            f"assignment / fused step ms: " + ", ".join(
                f"{form} " + ("does not fit" if t is None else
                              f"{t[0]:.4f} / {t[1]:.4f}")
                for form, t in times.items()))


def kernel_assign(torch, mods, sass: dict) -> dict:
    dops, dref, synth = mods["dops"], mods["dref"], mods["synth"]
    spec = spec_of(synth, ASSIGN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device=DEV)
    g = torch.Generator().manual_seed(SEED)
    c = x[torch.randperm(x.shape[0], generator=g)[:spec.clusters].to(DEV)]
    n, d = x.shape
    k = c.shape[0]
    idx, dist = dops.assign_clusters(x, c)
    ridx, rdist = dref.assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    rechecks = recheck_line(dops, dops.assign_clusters,
                            f"assignment n={n} d={d} k={k}", n)
    mism = int((idx != ridx).sum())
    err = float((dist - rdist).abs().max())
    check(mism == 0, f"assignment: {mism} indices differ from the plain version")
    check(bool(torch.allclose(dist, rdist, rtol=2e-4, atol=2e-4)),
          f"assignment: distances differ by up to {err}")
    log(f"assignment n={n} d={d} k={k}: indices exact, distances "
        f"{'bit-identical' if same_bits(torch, dist, rdist) else 'differ'}"
        f" (max |diff| {err!r})")
    # near-ties, duplicates, points on centroids, inf and NaN rows: index
    # and score bits of the plain version, with and without distances
    for dt in (32, 5):
        xt, ct = near_ties(torch, dt, SEED + dt)
        for with_dists in (False, True):
            tidx, tout = dops.assign_clusters(xt, ct, with_dists=with_dists)
            tridx, trscore = dref.assign_scores_ref(xt, ct)
            trout = dref.add_point_norms(xt, trscore) if with_dists else trscore
            check(bool(torch.equal(tidx, tridx)) and same_bits(torch, tout,
                                                                trout),
                  f"assignment near-ties d={dt}: differs from the plain "
                  f"version (with_dists={with_dists})")
        recheck_line(dops, dops.assign_clusters,
                     f"assignment near-ties n={xt.shape[0]} d={dt} "
                     f"k={ct.shape[0]}", xt.shape[0])
    log("assignment near-ties (midpoints +-1 ulp, duplicate centroids, points "
        "on centroids, inf and NaN rows) at d=32 and d=5: bit-identical")
    ms = time_ms(torch, lambda: dops.assign_clusters(x, c), reps=20)
    kernel_only = time_ms(
        torch, lambda: dops.assign_clusters(x, c, with_dists=False), reps=20)
    plain = time_ms(torch, lambda: dref.assign_clusters_ref(x, c), reps=3)
    lib = time_ms(torch, lambda: torch.cdist(x, c).argmin(1), reps=20)
    # the scores as three TF32 products on the tensor cores; and the same
    # work's fp32 CUDA-core bound
    b, by = bound(n * d * 4 + k * d * 4 + n * 8, 3 * 2.0 * n * k * d,
                  PEAK_TF32)
    b32, _ = bound(n * d * 4 + k * d * 4 + n * 8, 2.0 * n * k * d)
    return dict(name="assign_clusters", route="cuda",
                source="src/repro_torch/csrc/distance.cu",
                replaces="src/repro/kernels/distance/distance.py:46",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib, bound_fp32_ms=b32,
                shape=f"n={n} d={d} k={k}", kernel_only_ms=kernel_only,
                rechecks=rechecks, sass=sass)


def _member_abs_sums(torch, x, idx, mask, k):
    """Per centroid and feature, the sum of |x| over its unmasked members."""
    out = torch.zeros((k, x.shape[1]), device=x.device)
    cols = torch.arange(k, device=x.device)
    for r in range(0, x.shape[0], 1 << 18):
        oh = ((idx[r:r + (1 << 18), None] == cols[None, :])
              & mask[r:r + (1 << 18), None]).float()
        out += oh.T @ x[r:r + (1 << 18)].abs()
    return out


def kernel_fused(torch, mods, sass: dict) -> dict:
    fops, dops, dref, synth = (mods["fops"], mods["dops"], mods["dref"],
                               mods["synth"])
    spec = spec_of(synth, ASSIGN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device=DEV)
    g = torch.Generator().manual_seed(SEED + 2)
    n, d = x.shape
    k = spec.clusters
    c = x[torch.randperm(n, generator=g)[:k].to(DEV)].contiguous()
    mask = (torch.arange(n) < int(n * (1 - FUSED_MASKED_FRACTION))).to(DEV)

    def compare(x, c, mask, what) -> float:
        idx, sums, counts, inert = fops.fused_masked_assign_update(x, c, mask)
        ridx, rsums, rcounts, rinert = dref.fused_masked_assign_update_ref(
            x, c, mask)
        aidx, _ = dops.assign_clusters(x, c, with_dists=False)
        again = fops.fused_masked_assign_update(x, c, mask)
        torch.cuda.synchronize()
        rechecks[what] = recheck_line(dops, fops.fused_masked_assign_update,
                                      f"fused {what}", x.shape[0])
        check(bool(torch.equal(idx, ridx)),
              f"fused {what}: {int((idx != ridx).sum())} indices differ "
              f"from the plain version")
        check(bool(torch.equal(idx, aidx)),
              f"fused {what}: indices differ from assign_clusters")
        check(bool(torch.equal(counts, rcounts)),
              f"fused {what}: counts differ from the plain version")
        check(int(counts.sum()) == int(mask.sum()),
              f"fused {what}: counts sum to {int(counts.sum())}")
        # rtol 1e-4 against the scale of each sum: the summed magnitudes of
        # the cluster's members (a coordinate sum that cancels to near 0
        # keeps no relative precision in fp32, in any summation order)
        scale = _member_abs_sums(torch, x, ridx, mask, c.shape[0])
        check(bool(((sums - rsums).abs() <= 1e-4 * scale + 1e-6).all()),
              f"fused {what}: sums differ by up to "
              f"{float((sums - rsums).abs().max())}")
        check(bool(torch.allclose(inert, rinert, rtol=1e-4, atol=0.0)),
              f"fused {what}: inertia {float(inert)} vs {float(rinert)}")
        check(all(bool(torch.equal(a, b)) for a, b in
                  zip((idx, sums, counts, inert), again)),
              f"fused {what}: two launches differ (not deterministic)")
        err = max(float((sums - rsums).abs().max()),
                  float((inert - rinert).abs()))
        log(f"fused {what}: indices equal to plain and assign_clusters, "
            f"counts exact, max |dsums| {float((sums - rsums).abs().max())!r}"
            f", inertia {float(inert)!r} vs {float(rinert)!r}, "
            f"two launches bitwise equal")
        return err

    rechecks = {}
    err = compare(x, c, mask, f"n={n} d={d} k={k}")
    nl, kl = FUSED_LARGE_K["n"], FUSED_LARGE_K["k"]
    xl = x[:nl].contiguous()
    cl = x[torch.randperm(n, generator=g)[:kl].to(DEV)].contiguous()
    ml = (torch.arange(nl) < int(nl * (1 - FUSED_MASKED_FRACTION))).to(DEV)
    compare(xl, cl, ml, f"n={nl} d={d} k={kl}")
    # near-ties (as for the assignment): indices of the plain version and of
    # assign_clusters, counts exact; the plain version's one-hot product
    # turns a masked-out inf or NaN row into NaN sums (0 * inf), so its sums
    # are taken over the finite rows
    for dt in (32, 5):
        xt, ct = near_ties(torch, dt, SEED + dt)
        finite = torch.isfinite(xt).all(1)
        mt = finite & (torch.arange(xt.shape[0], device=DEV) % 5 != 0)
        tidx, tsums, tcounts, tinert = fops.fused_masked_assign_update(
            xt, ct, mt)
        tridx, _, trcounts, trinert = dref.fused_masked_assign_update_ref(
            xt, ct, mt)
        _, trsums, _, _ = dref.fused_masked_assign_update_ref(
            xt[finite], ct, mt[finite])
        taidx, _ = dops.assign_clusters(xt, ct)
        torch.cuda.synchronize()
        what = f"near-ties n={xt.shape[0]} d={dt} k={ct.shape[0]}"
        rechecks[what] = recheck_line(
            dops, fops.fused_masked_assign_update, f"fused {what}",
            xt.shape[0])
        check(bool(torch.equal(tidx, tridx)) and bool(torch.equal(tidx, taidx))
              and bool(torch.equal(tcounts, trcounts)),
              f"fused {what}: indices or counts differ from the plain version")
        tscale = _member_abs_sums(torch, xt[finite], tridx[finite], mt[finite],
                                  ct.shape[0])
        check(bool(((tsums - trsums).abs() <= 1e-4 * tscale + 1e-6).all())
              and bool(torch.allclose(tinert, trinert, rtol=1e-4, atol=0.0)),
              f"fused {what}: sums or inertia differ from the plain version")
    log("fused near-ties at d=32 and d=5: indices equal to plain and "
        "assign_clusters, counts exact, sums and inertia within 1e-4")

    ms = time_ms(torch, lambda: fops.fused_masked_assign_update(x, c, mask),
                 reps=20)
    plain = time_ms(
        torch, lambda: dref.fused_masked_assign_update_ref(x, c, mask), reps=3)
    w = mask.float()

    def composed():
        # a yardstick of stock PyTorch calls, never called by the port
        a = torch.cdist(x, c).argmin(1)
        onehot = (a[:, None] == torch.arange(k, device=x.device)).float()
        onehot *= w[:, None]
        return onehot.T @ x, onehot.sum(0)

    lib = time_ms(torch, composed, reps=10)
    moved = n * d * 4 + 5 * n + 8 * k * d + 4 * k + 4
    # the scores as three TF32 products on the tensor cores; and the same
    # work's fp32 CUDA-core bound
    b, by = bound(moved, 3 * 2.0 * n * k * d, PEAK_TF32)
    b32, _ = bound(moved, 2.0 * n * k * d)
    return dict(name="fused_masked_assign_update", route="cuda",
                source="src/repro_torch/csrc/fused.cu",
                replaces="src/repro/kernels/distance/fused.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib, bound_fp32_ms=b32,
                rechecks=rechecks, sass=sass,
                shape=f"n={n} d={d} k={k} masked={FUSED_MASKED_FRACTION}",
                library_call="cdist(x, c).argmin(1) + masked one-hot "
                             "matmul (composed)",
                launch_shape=list(fops.launch_shape(n, k, d)))


def kernel_lloyd(torch, mods) -> dict:
    """The narrow-row sums (``fops.lloyd_sums``) at each of LLOYD_SHAPES,
    on the paper's blobs labelled by the assignment kernel against k of
    their rows: bit for bit its plain model (``dref.lloyd_sums_ref``, run
    on the card), counts exact, sums within m u sum |x| of the float64
    sums (m additions on the longest path), two launches bitwise equal.
    Times the kernel and pass 2 (CUDA-graph replays; queued calls by
    events), the plain model, and the one-hot product it replaced
    (``kmeans._weighted_sums``) as the library call.  The row's numbers
    are the first shape's."""
    fops, dops, dref, synth, kmeans = (mods["fops"], mods["dops"],
                                       mods["dref"], mods["synth"],
                                       mods["kmeans"])
    shapes = []
    for shape in LLOYD_SHAPES:
        x, _, _ = synth.make_blobs(
            torch.Generator(device=DEV).manual_seed(SEED),
            spec_of(synth, shape), device=DEV)
        n, d = x.shape
        k = shape["clusters"]
        c = x[:k].clone()           # the rows are shuffled
        idx, _ = dops.assign_clusters(x, c, with_dists=False)
        blocks = fops.lloyd_blocks(n)
        sums, counts = fops.lloyd_sums(x, idx, k)
        again = fops.lloyd_sums(x, idx, k)
        rsums, rcounts = dref.lloyd_sums_ref(x, idx, k, blocks)
        exact = torch.zeros((k, d), dtype=torch.float64, device=DEV)
        scale = torch.zeros_like(exact)
        exact.index_add_(0, idx.long(), x.double())
        scale.index_add_(0, idx.long(), x.double().abs())
        bins = torch.bincount(idx.long(), minlength=k).float()
        torch.cuda.synchronize()
        m = (-(-n // (blocks * dref.LLOYD_THREADS)) + 5 + 7
             + -(-blocks // dref.REDUCE_RUNS) + dref.REDUCE_RUNS - 1)
        dev = (sums.double() - exact).abs()
        err = float(dev.max())
        what = f"lloyd_sums n={n} d={d} k={k}"
        check(bool(torch.equal(sums, rsums))
              and bool(torch.equal(counts, rcounts)),
              f"{what}: differs from its plain model")
        check(bool(torch.equal(again[0], sums))
              and bool(torch.equal(again[1], counts)),
              f"{what}: two launches differ")
        check(bool(torch.equal(counts, bins)), f"{what}: counts not exact")
        check(bool((dev <= 1.01 * m * 2.0 ** -24 * scale).all()),
              f"{what}: sums {err} from the float64 sums, past m u sum|x| "
              f"(m = {m})")
        ms = graph_ms(torch, lambda: fops.lloyd_sums(x, idx, k))
        events = time_ms(torch, lambda: fops.lloyd_sums(x, idx, k), reps=50)
        plain = time_ms(
            torch, lambda: dref.lloyd_sums_ref(x, idx, k, blocks), reps=3)
        lib = time_ms(torch, lambda: kmeans._weighted_sums(x, idx, k),
                      reps=10)
        b, by = bound(n * (4 * d + 4), n * d)
        shapes.append(dict(shape=f"n={n} d={d} k={k}", blocks=blocks,
                           ms=ms, events_ms=events, plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by,
                           max_abs_err=err))
        log(f"{what}: {blocks} blocks, equal to its plain model bit for "
            f"bit, counts exact, max |sums - float64| {err!r}; device "
            f"{ms!r} ms (queued {events!r}), bound {b!r} ms ({by}), plain "
            f"{plain!r} ms, one-hot product {lib!r} ms")
        del x, c, idx, exact, scale, dev, sums, rsums, again
        torch.cuda.empty_cache()
    first = shapes[0]
    return dict(name="lloyd_sums", route="cuda",
                source="src/repro_torch/csrc/fused.cu",
                replaces="none (the reference's update, "
                         "src/repro/core/kmeans.py:84, is one_hot + einsum)",
                max_abs_err=first["max_abs_err"], ms=first["ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=first["library_ms"],
                events_ms=first["events_ms"],
                library_call="kmeans._weighted_sums: (n, k) one-hot, "
                             "onehot.T @ x, onehot.sum(0)",
                shape=first["shape"], shapes=shapes,
                launch_shape=[first["blocks"], dref.LLOYD_THREADS])


def _service_dbscan_item(mods):
    """The first request of the service phase's DBSCAN workload, padded to
    its bucket as the batch executor pads it (the far-diagonal ladder):
    the array the service's kernels are launched on."""
    import numpy as np
    from repro_torch.service import executor
    work = _svc_workload(mods["serve_mine"], "dbscan", SVC_DBSCAN, SEED + 1)
    _t, _a, x, params = work[0]
    n_max = 1 << (max(w[2].shape[0] for w in work) - 1).bit_length()
    high = max(float(np.max(w[2])) for w in work)
    return executor._pad_item(x, n_max, "dbscan", params["eps"], high), \
        params["eps"]


def _neighbor_shape(torch, mods, what, x, eps, reps) -> dict:
    """Both neighbour kernels at one shape: equal to the plain versions
    (torch.equal), two launches bitwise equal; kernel, plain and composed
    library times; the exact rechecks per pair scored; the bounds."""
    nops, nref = mods["nops"], mods["nref"]
    n, d = x.shape
    g = torch.Generator().manual_seed(SEED + n)
    front = (torch.rand(n, generator=g) < FRONTIER_FRACTION).to(DEV)
    nf = int(front.sum())
    deg = nops.epsilon_degree(x, eps)
    deg_rc = nops.rechecks(nops.epsilon_degree)
    deg2 = nops.epsilon_degree(x, eps)
    reach = nops.expand_frontier(x, front, eps)
    exp_rc = nops.rechecks(nops.expand_frontier)
    reach2 = nops.expand_frontier(x, front, eps)
    rdeg = nref.epsilon_degree_ref(x, eps)
    rreach = nref.expand_frontier_ref(x, front, eps)
    torch.cuda.synchronize()
    check(bool(torch.equal(deg, rdeg)),
          f"degree {what}: {int((deg != rdeg).sum())} points differ from the "
          f"plain version")
    check(bool(torch.equal(reach, rreach)),
          f"expansion {what}: {int((reach != rreach).sum())} rows differ "
          f"from the plain version")
    check(bool(torch.equal(deg, deg2)) and bool(torch.equal(reach, reach2)),
          f"neighbour kernels {what}: two launches differ")
    eps_t = torch.tensor(float(eps), device=DEV)
    xf = x[front]

    def composed_degree():
        # cdist + threshold + row count, chunked (yardstick, never used)
        return torch.cat([(torch.cdist(x[r:r + 2048], x) <= eps_t).sum(1)
                          for r in range(0, n, 2048)])

    def composed_expand():
        return torch.cat([(torch.cdist(x[r:r + 8192], xf) <= eps_t).any(1)
                          for r in range(0, n, 8192)])

    big = n >= 65536
    t = dict(
        # the kernels line's max_abs_err, read from the outputs compared
        # (reach as 0 / 1)
        deg_err=float((deg - rdeg).abs().max()),
        exp_err=float((reach.int() - rreach.int()).abs().max()),
        deg_host_us=host_us(torch, lambda: nops.epsilon_degree(x, eps)),
        exp_host_us=host_us(torch,
                            lambda: nops.expand_frontier(x, front, eps)),
        deg_ms=time_ms(torch, lambda: nops.epsilon_degree(x, eps), reps=reps),
        exp_ms=time_ms(torch, lambda: nops.expand_frontier(x, front, eps),
                       reps=2 * reps),
        deg_plain=time_ms(torch, lambda: nref.epsilon_degree_ref(x, eps),
                          reps=1 if big else 3),
        exp_plain=time_ms(torch, lambda: nref.expand_frontier_ref(
            x, front, eps), reps=2 if big else 5),
        deg_lib=time_ms(torch, composed_degree, reps=3),
        exp_lib=time_ms(torch, composed_expand, reps=5))
    # the packed products on the tensor cores (2 operations per
    # multiply-add, 8 ks deep a pair); the direct form's fp32 figure beside
    # it: 3 d un-fused operations a pair counted as FLOPs at the fp32 peak.
    # The degree needs each unordered pair once (d2 is symmetric), the
    # point itself included: n (n + 1) / 2 pairs.
    depth = 8 * nref.pack_ksteps(d)
    half = n * (n + 1) / 2
    t["deg_bound"], t["deg_by"] = bound(n * d * 4 + n * 4,
                                        2.0 * depth * half, PEAK_TF32)
    t["deg_fp32"], _ = bound(n * d * 4 + n * 4, 3.0 * d * half)
    t["exp_bound"], t["exp_by"] = bound(n * d * 4 + 2 * n,
                                        2.0 * depth * n * nf, PEAK_TF32)
    t["exp_fp32"], _ = bound(n * d * 4 + 2 * n, 3.0 * d * n * nf)
    # device time of one call (the pack, gather and main kernels), from
    # the profiler: below ~n = 16384 the event means over queued calls read
    # the host's rate of calls instead
    t["deg_device_ms"] = profile_window(
        torch, f"degree {what}", lambda: nops.epsilon_degree(x, eps))[
            "busy_ms"]
    t["exp_device_ms"] = profile_window(
        torch, f"expansion {what}",
        lambda: nops.expand_frontier(x, front, eps))["busy_ms"]
    t["deg_rechecks"] = dict(rechecks=deg_rc[0], pairs=deg_rc[1],
                             per_pair=deg_rc[0] / max(deg_rc[1], 1))
    t["exp_rechecks"] = dict(rechecks=exp_rc[0], pairs=exp_rc[1],
                             per_pair=exp_rc[0] / max(exp_rc[1], 1))
    t.update(shape=f"{what}: n={n} d={d} eps={eps}", frontier=nf,
             plan_degree=list(nops.plan(n, d)),
             plan_expand=list(nops.plan(n, d, True)))
    log(f"neighbour {t['shape']}: degree and expansion (frontier {nf}) "
        f"equal to the plain versions, two launches bitwise equal; degree "
        f"{t['deg_ms']:.4f} ms (plain {t['deg_plain']:.3f}, composed "
        f"{t['deg_lib']:.3f}, bound {t['deg_bound']:.4f}), expansion "
        f"{t['exp_ms']:.4f} ms (plain {t['exp_plain']:.3f}, composed "
        f"{t['exp_lib']:.3f}, bound {t['exp_bound']:.4f}); rechecks per "
        f"pair: degree {t['deg_rechecks']['per_pair']!r} "
        f"({deg_rc[0]} of {deg_rc[1]}), expansion "
        f"{t['exp_rechecks']['per_pair']!r} ({exp_rc[0]} of {exp_rc[1]}); "
        f"host time a call (queued, no sync): degree "
        f"{t['deg_host_us']:.1f} us, expansion {t['exp_host_us']:.1f} us; "
        f"device time a call (profiler): degree {t['deg_device_ms']:.4f} "
        f"ms, expansion {t['exp_device_ms']:.4f} ms")
    return t


def kernel_neighbor(torch, mods, sass: dict) -> list:
    """The neighbour kernels at the one-job path's shape (n = 65536, the
    row in the kernels line), the service's (a padded request of the
    service phase, n = 16384) and n = 2048."""
    nops, synth = mods["nops"], mods["synth"]
    # the profiler's first window pays its own set-up
    profile_window(torch, "warm-up", lambda: torch.ones(8, device=DEV) + 1)
    spec = spec_of(synth, DBSCAN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device=DEV)
    eps = spec.dbscan_eps
    one_job = _neighbor_shape(torch, mods, "one-job", x, eps, reps=10)
    xs, seps = _service_dbscan_item(mods)
    service = _neighbor_shape(torch, mods, "service",
                              torch.from_numpy(xs).to(DEV), seps, reps=20)
    small, _, _ = synth.make_blobs(SEED, synth.ClusterSpec(4, 8, 256),
                                   device=DEV)
    n2048 = _neighbor_shape(torch, mods, "n=2048", small, eps, reps=50)
    shapes = [one_job, service, n2048]
    common = dict(route="cuda", source="src/repro_torch/csrc/neighbor.cu",
                  library_call="cdist + threshold + reduction, chunked "
                               "(composed)", sass=sass,
                  shapes=shapes)
    return [
        dict(name="epsilon_degree",
             replaces="src/repro/kernels/neighbor/neighbor.py:53",
             max_abs_err=one_job["deg_err"], ms=one_job["deg_ms"],
             plain_ms=one_job["deg_plain"], bound_ms=one_job["deg_bound"],
             bound_by=one_job["deg_by"], library_ms=one_job["deg_lib"],
             bound_fp32_ms=one_job["deg_fp32"], shape=one_job["shape"],
             rechecks=one_job["deg_rechecks"], **common),
        dict(name="expand_frontier",
             replaces="src/repro/kernels/neighbor/neighbor.py:65",
             max_abs_err=one_job["exp_err"], ms=one_job["exp_ms"],
             plain_ms=one_job["exp_plain"], bound_ms=one_job["exp_bound"],
             bound_by=one_job["exp_by"], library_ms=one_job["exp_lib"],
             bound_fp32_ms=one_job["exp_fp32"],
             shape=f"{one_job['shape']} frontier={one_job['frontier']}",
             rechecks=one_job["exp_rechecks"], **common),
    ]


def _dist_dbscan_request(mods):
    """Phase 4d's DBSCAN request (tenant, algo, points, params) and its
    bucket as the batch executor pads it (131,072 rows, the far-diagonal
    pads): the points the distributed lane is launched on."""
    import numpy as np
    from repro_torch.service import executor
    (req,) = mods["serve_mine"].build_workload(
        1, 1, "dbscan", seed=SEED + 11, **DIST_DBSCAN)
    x, params = req[2], req[3]
    n_max = 1 << (x.shape[0] - 1).bit_length()
    return req, executor._pad_item(x, n_max, "dbscan", params["eps"],
                                   float(np.max(x)))


def card_mesh(mods, shards: int):
    """A mesh of ``shards`` shards, every one on the card."""
    import torch
    return mods["dist"].Mesh((torch.device(DEV, 0),) * shards)


def kernel_cross(torch, mods, sass: dict) -> list:
    """The cross entries at the ring's shape: phase 4d's DBSCAN request
    padded to 131,072 rows and cut into 4 shards of 32,768; the rows and
    the columns both the last shard (1,696 points and 31,072 far-diagonal
    pads, the ring's most pad-laden step), a ~5% frontier.  Each equal to
    its plain twin (torch.equal), two launches bitwise equal; kernel,
    plain and composed library times, the device time a call, the bound
    (the packed product over rows x columns pairs); the rechecks per pair
    scored at every (rows, columns) pair of the 4-shard ring."""
    nops, nref, dist = mods["nops"], mods["nref"], mods["dist"]
    req, x_pad = _dist_dbscan_request(mods)
    high = float(req[2].max())   # pads lie beyond every real coordinate
    eps = 2.0
    shards = dist.shard(card_mesh(mods, DIST_SHARDS),
                        torch.from_numpy(x_pad))
    ring = {}
    for i, rows in enumerate(shards):
        for j, cols in enumerate(shards):
            nops.epsilon_degree_cross(rows, cols, eps)
            total, pairs = nops.rechecks(nops.epsilon_degree_cross)
            ring[f"{i},{j}"] = total / max(pairs, 1)
    log("cross degree, rechecks per pair scored at each (rows, columns) "
        "shard pair of the 4-shard ring (shard 3 holds the pads): "
        + json.dumps(ring))
    # what the pads' rechecks cost: the same call on a step without pads
    plain_step = time_ms(torch, lambda: nops.epsilon_degree_cross(
        shards[0], shards[1], eps), reps=10)
    log(f"cross degree on a ring step without pads (rows shard 0, columns "
        f"shard 1): {plain_step:.4f} ms")
    rows = cols = shards[-1]
    nr, d = rows.shape
    nc = cols.shape[0]
    g = torch.Generator().manual_seed(SEED + nc)
    front = (torch.rand(nc, generator=g) < FRONTIER_FRACTION).to(DEV)
    nf = int(front.sum())
    deg = nops.epsilon_degree_cross(rows, cols, eps)
    deg_rc = nops.rechecks(nops.epsilon_degree_cross)
    deg2 = nops.epsilon_degree_cross(rows, cols, eps)
    reach = nops.expand_frontier_cross(rows, cols, front, eps)
    exp_rc = nops.rechecks(nops.expand_frontier_cross)
    reach2 = nops.expand_frontier_cross(rows, cols, front, eps)
    rdeg = nref.epsilon_degree_cross_ref(rows, cols, eps)
    rreach = nref.expand_frontier_cross_ref(rows, cols, front, eps)
    torch.cuda.synchronize()
    check(bool(torch.equal(deg, rdeg)),
          f"cross degree: {int((deg != rdeg).sum())} rows differ from the "
          f"plain twin")
    check(bool(torch.equal(reach, rreach)),
          f"cross expansion: {int((reach != rreach).sum())} rows differ "
          f"from the plain twin")
    check(bool(torch.equal(deg, deg2)) and bool(torch.equal(reach, reach2)),
          "cross entries: two launches differ")
    eps_t = torch.tensor(eps, device=DEV)
    cf = cols[front]

    def composed_degree():
        # cdist + threshold + row count, chunked (yardstick, never used)
        return torch.cat([(torch.cdist(rows[r:r + 2048], cols) <= eps_t)
                          .sum(1) for r in range(0, nr, 2048)])

    def composed_expand():
        return torch.cat([(torch.cdist(rows[r:r + 8192], cf) <= eps_t).any(1)
                          for r in range(0, nr, 8192)])

    deg_call = lambda: nops.epsilon_degree_cross(rows, cols, eps)  # noqa
    exp_call = lambda: nops.expand_frontier_cross(rows, cols, front,  # noqa
                                                  eps)
    depth = 8 * nref.pack_ksteps(d)
    t = dict(
        deg_err=float((deg - rdeg).abs().max()),
        exp_err=float((reach.int() - rreach.int()).abs().max()),
        deg_host_us=host_us(torch, deg_call),
        exp_host_us=host_us(torch, exp_call),
        deg_ms=time_ms(torch, deg_call, reps=10),
        exp_ms=time_ms(torch, exp_call, reps=20),
        deg_plain=time_ms(torch, lambda: nref.epsilon_degree_cross_ref(
            rows, cols, eps), reps=2),
        exp_plain=time_ms(torch, lambda: nref.expand_frontier_cross_ref(
            rows, cols, front, eps), reps=3),
        deg_lib=time_ms(torch, composed_degree, reps=3),
        exp_lib=time_ms(torch, composed_expand, reps=5),
        deg_device_ms=profile_window(torch, "cross degree", deg_call)[
            "busy_ms"],
        exp_device_ms=profile_window(torch, "cross expansion", exp_call)[
            "busy_ms"])
    # PERF.md section 6's formula: the packed product (2 operations per
    # multiply-add, 8 ks deep) over the pairs the call needs, rows x
    # columns (rows x frontier columns for the expansion), at the TF32
    # tensor-core peak; bytes: both point sets once, the result once
    t["deg_bound"], t["deg_by"] = bound((nr + nc) * d * 4 + nr * 4,
                                        2.0 * depth * nr * nc, PEAK_TF32)
    t["exp_bound"], t["exp_by"] = bound((nr + nc) * d * 4 + nc + nr,
                                        2.0 * depth * nr * nf, PEAK_TF32)
    t["deg_fp32"], _ = bound((nr + nc) * d * 4 + nr * 4, 3.0 * d * nr * nc)
    t["exp_fp32"], _ = bound((nr + nc) * d * 4 + nc + nr, 3.0 * d * nr * nf)
    shape = (f"ring step: rows {nr} x cols {nc} d={d} eps={eps}, "
             f"{int((rows[:, 0] > high).sum())} pads")
    rc = {"degree": dict(rechecks=deg_rc[0], pairs=deg_rc[1],
                         per_pair=deg_rc[0] / max(deg_rc[1], 1)),
          "expansion": dict(rechecks=exp_rc[0], pairs=exp_rc[1],
                            per_pair=exp_rc[0] / max(exp_rc[1], 1))}
    log(f"cross entries {shape}: degree and expansion (frontier {nf}) "
        f"equal to the plain twins, two launches bitwise equal; degree "
        f"{t['deg_ms']:.4f} ms (device {t['deg_device_ms']:.4f}, plain "
        f"{t['deg_plain']:.3f}, composed {t['deg_lib']:.3f}, bound "
        f"{t['deg_bound']:.4f}), expansion {t['exp_ms']:.4f} ms (device "
        f"{t['exp_device_ms']:.4f}, plain {t['exp_plain']:.3f}, composed "
        f"{t['exp_lib']:.3f}, bound {t['exp_bound']:.4f}); rechecks per "
        f"pair: degree {rc['degree']['per_pair']!r} ({deg_rc[0]} of "
        f"{deg_rc[1]}), expansion {rc['expansion']['per_pair']!r} "
        f"({exp_rc[0]} of {exp_rc[1]}); host time a call: degree "
        f"{t['deg_host_us']:.1f} us, expansion {t['exp_host_us']:.1f} us; "
        f"plans {list(nops.plan(nr, d, cols=nc))} / "
        f"{list(nops.plan(nr, d, True, cols=nc))}")
    common = dict(route="cuda", source="src/repro_torch/csrc/neighbor.cu",
                  library_call="cdist + threshold + reduction, chunked "
                               "(composed)", sass=sass,
                  ring_rechecks_per_pair=ring)
    return [
        dict(name="epsilon_degree_cross",
             replaces="src/repro/kernels/neighbor/neighbor.py:53",
             max_abs_err=t["deg_err"], ms=t["deg_ms"],
             plain_ms=t["deg_plain"], bound_ms=t["deg_bound"],
             bound_by=t["deg_by"], library_ms=t["deg_lib"],
             bound_fp32_ms=t["deg_fp32"], device_ms=t["deg_device_ms"],
             host_us=t["deg_host_us"], shape=shape,
             rechecks=rc["degree"], **common),
        dict(name="expand_frontier_cross",
             replaces="src/repro/kernels/neighbor/neighbor.py:65",
             max_abs_err=t["exp_err"], ms=t["exp_ms"],
             plain_ms=t["exp_plain"], bound_ms=t["exp_bound"],
             bound_by=t["exp_by"], library_ms=t["exp_lib"],
             bound_fp32_ms=t["exp_fp32"], device_ms=t["exp_device_ms"],
             host_us=t["exp_host_us"], shape=f"{shape} frontier={nf}",
             rechecks=rc["expansion"], **common),
    ]


def attention_work(b, s, h, kv, d, itemsize, causal) -> tuple:
    """(bytes, operations) that attention must move and do: q, k, v read
    once and o written once; 2 * 2 * D operations per live (query, key)
    pair (the causal ones only: this run's queries and keys align)."""
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * itemsize
    pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
    return nbytes, 4.0 * d * pairs


def close_to_plain(torch, aref, out, ref, ref32, dt: str,
                   what: str) -> tuple:
    """Hold an attention output against the plain version: elementwise
    against ``ref`` (the plain version in the inputs' dtype) and per query
    block against ``ref32`` (in fp32).  Returns (max |err|, block error)."""
    err = float((out.float() - ref.float()).abs().max())
    tol = ATTN_TOL[dt]
    check(bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)),
          f"{what}: differs from the plain version by up to {err}")
    blk = aref.block_error(out, ref32)
    check(blk <= ATTN_BLOCK_TOL[dt],
          f"{what}: a 128-row query block differs from the plain version "
          f"by {blk} of its norm (limit {ATTN_BLOCK_TOL[dt]})")
    return err, blk


def kernel_attention(torch, mods, sass: dict) -> list:
    """Every ATTN_SHAPES row on the card against the plain version; the
    kernels line's rows: the first shape's (OLMo-1B's prefill, with the
    "simt" route on its bf16 inputs) and those ATTN_ROWS names, each
    timed beside the plain version and SDPA."""
    aops, aref = mods["aops"], mods["aref"]
    F = torch.nn.functional
    by_route = aops.flash_attention.launches_by_route
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    rows = []
    for what, b, s, h, kv, d, dt, causal in ATTN_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, d, generator=g, device=DEV).to(dtype)
        k = torch.randn(b, s, kv, d, generator=g, device=DEV).to(dtype)
        v = torch.randn(b, s, kv, d, generator=g, device=DEV).to(dtype)
        route = ATTN_ROUTE[dt]
        label = (f"{what} (B={b} S={s} H={h} KV={kv} D={d} {dt} "
                 f"causal={causal})")
        before = by_route[route]
        out = aops.flash_attention(q, k, v, causal=causal)
        again = aops.flash_attention(q, k, v, causal=causal)
        check(by_route[route] == before + 2,
              f"flash attention {label}: did not take the {route!r} route "
              f"({by_route})")
        ref32 = aref.attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal)
        ref = ref32.to(dtype)   # what attention_ref(q, k, v) gives
        torch.cuda.synchronize()
        err, blk = close_to_plain(torch, aref, out, ref, ref32, dt,
                                  f"flash attention {label}")
        check(bool(torch.equal(out, again)),
              f"flash attention {label}: two launches differ")
        del again
        ms = time_ms(torch, lambda: aops.flash_attention(q, k, v,
                                                         causal=causal),
                     reps=10)
        nbytes, ops = attention_work(b, s, h, kv, d, q.element_size(), causal)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        bnd, by = bound(nbytes, ops, peak)
        log(f"flash attention {label}: route {route}, max |err| {err!r} "
            f"(tol {ATTN_TOL[dt]}), block error {blk!r} (tol "
            f"{ATTN_BLOCK_TOL[dt]}), two launches bitwise equal, {ms:.4f} ms, "
            f"{ops:.4g} operations, {ops / ms / 1e9:.1f} TFLOP/s, bound "
            f"{bnd:.4f} ms ({by}, {dt})")
        if rows and what not in ATTN_ROWS:
            del ref, ref32
            continue
        b32, _ = bound(nbytes, ops, PEAK_FP32)
        shape = f"B={b} S={s} H={h} KV={kv} D={d} {dt} causal={causal}"
        plain = time_ms(torch, lambda: aref.attention_ref(q, k, v,
                                                          causal=causal),
                        reps=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=h != kv), reps=10)
        common = dict(route="cuda", source="src/repro_torch/csrc/flash_sm90.cu",
                      replaces="src/repro/kernels/attention/attention.py:42",
                      max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                      bound_by=by, library_ms=lib, bound_fp32_ms=b32,
                      block_error=blk, shape=shape,
                      library_call="torch.nn.functional."
                                   "scaled_dot_product_attention")
        if rows and what not in ATTN_SIMT:
            log(f"flash attention {label}: tc {ms!r} ms, plain {plain!r} ms, "
                f"SDPA {lib!r} ms")
            rows.append(dict(common, name=ATTN_ROWS[what]))
            del ref, ref32, q, k, v, qt, kt, vt
            continue
        # the serving shape (and ATTN_SIMT's): the CUDA-core route on the
        # same bf16 inputs (the kernel the tensor-core one replaced on this
        # path, and still the bf16 route at other widths), checked and
        # timed beside the plain version and SDPA
        simt_out = aops._launch(q, k, v, causal, "simt")
        torch.cuda.synchronize()
        simt_err, simt_blk = close_to_plain(
            torch, aref, simt_out, ref, ref32, dt,
            f"flash attention {label} on \"simt\"")
        log(f"flash attention {label}: route simt on the same inputs, max "
            f"|err| {simt_err!r}, block error {simt_blk!r}")
        del simt_out, ref, ref32
        simt = time_ms(torch, lambda: aops._launch(q, k, v, causal, "simt"),
                       reps=3)
        log(f"flash attention {label}: tc {ms!r} ms, simt {simt!r} ms "
            f"({simt / ms:.1f} x tc), plain {plain!r} ms, SDPA {lib!r} ms")
        if what in ATTN_SIMT:
            check(simt >= ATTN_SIMT_SPEEDUP * ms,
                  f"flash attention {label}: \"tc\" {ms} ms is not "
                  f"{ATTN_SIMT_SPEEDUP}x below \"simt\"'s {simt} ms")
        row = dict(common, name=ATTN_ROWS.get(what, "flash_attention"),
                   simt_ms=simt, simt_max_abs_err=simt_err,
                   simt_block_error=simt_blk)
        if not rows:
            row["sass"] = sass
        rows.append(row)
        del q, k, v, qt, kt, vt
    return rows


@contextlib.contextmanager
def plain_attention(mods):
    """The layers' one attention call patched to the plain version, for the
    length of the block (the package has no switch for it)."""
    layers, aref = mods["layers"], mods["aref"]
    saved = layers.flash_attention
    layers.flash_attention = (
        lambda q, k, v, causal=True: aref.attention_ref(q, k, v,
                                                        causal=causal))
    try:
        yield
    finally:
        layers.flash_attention = saved


def lm_serving_path(torch, mods, counters) -> dict:
    """Slice 3's main path: LM serving at OLMo-1B's full width."""
    serve, lm, configs = mods["serve"], mods["lm"], mods["configs"]
    cfg = configs.get_config(SERVE["arch"])
    # first-call set-up (cuBLAS handles, the kernel library) outside the
    # timed run
    t0 = time.time()
    serve.serve_batch(arch=SERVE["arch"], smoke=False, batch=1, prompt_len=64,
                      gen=2, device=DEV, seed=SEED)
    log(f"serve warm-up (batch 1, prompt 64): {time.time() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.time()
    out = serve.serve_batch(smoke=False, device=DEV, seed=SEED, **SERVE)
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    by_route = dict(counters["flash_attention"].launches_by_route)
    check(launches["flash_attention"] == cfg.n_layers,
          f"serve: {launches['flash_attention']} flash launches for "
          f"{cfg.n_layers} layers (one per prefill layer, none in decode)")
    check(by_route == {"tc": cfg.n_layers, "simt": 0},
          f"serve: flash launches by route {by_route}; every prefill layer "
          f"must take the tensor-core route")
    check(all(n == 0 for name, n in launches.items()
              if name != "flash_attention"),
          f"serve: a mining kernel launched: {launches}")
    check(out["logits_finite"], "serve: a logit is not finite")
    gen = out["generated"]
    check(gen is not None and tuple(gen.shape) == (SERVE["batch"],
                                                   SERVE["gen"]),
          f"serve: generated {None if gen is None else tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          "serve: a token outside the vocabulary")
    log(f"serve {SERVE['arch']} full width bf16 (batch {SERVE['batch']}, "
        f"prompt {SERVE['prompt_len']}, gen {SERVE['gen']}): prefill_s "
        f"{out['prefill_s']!r}, decode_s {out['decode_s']!r} "
        f"({out['decode_s'] / SERVE['gen'] * 1e3:.3f} ms per token), "
        f"tokens_per_s {out['tokens_per_s']!r}, wall with weight init "
        f"{wall:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
        f"launches {launches['flash_attention']} by route {by_route}, all "
        f"logits finite")
    del out
    profile_serving(torch, mods, cfg)

    # the kernel route against the plain route, fp32, same weights/prompts
    c = SERVE_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(g, cfg32, device=DEV)
    prompts = torch.randint(0, cfg.vocab, (c["batch"], c["prompt_len"]),
                            generator=g, device=DEV)
    reset(counters)
    a = serve.generate(params, prompts, cfg32, gen=c["gen"])
    check(counters["flash_attention"].launches_by_route["simt"]
          == counters["flash_attention"].launches == cfg.n_layers,
          "fp32 check: the kernel route did not launch the CUDA-core kernel "
          "once per layer")
    with plain_attention(mods):
        reset(counters)
        b = serve.generate(params, prompts, cfg32, gen=c["gen"])
        check(counters["flash_attention"].launches == 0,
              "fp32 check: the plain route launched the kernel")
    la = a["prefill_logits"][..., :cfg.vocab]
    lb = b["prefill_logits"][..., :cfg.vocab]
    diff = float((la - lb).abs().max())
    scale = float(lb.abs().max())
    check(a["logits_finite"] and b["logits_finite"],
          "fp32 check: a logit is not finite")
    check(diff <= SERVE_LOGIT_RTOL * scale,
          f"fp32 check: prefill logits differ by {diff} (largest |logit| "
          f"{scale}, limit {SERVE_LOGIT_RTOL} relative)")
    check(bool(torch.equal(a["generated"], b["generated"])),
          "fp32 check: greedy tokens differ between the kernel and plain "
          "routes")
    log(f"serve fp32 check (batch {c['batch']}, prompt {c['prompt_len']}, "
        f"gen {c['gen']}): kernel vs plain route prefill logits max |diff| "
        f"{diff!r} of largest |logit| {scale!r} "
        f"(rel {diff / scale!r}), {c['gen']} greedy tokens equal; prefill_s "
        f"kernel {a['prefill_s']!r} / plain {b['prefill_s']!r}")
    del params, a

    # bf16 (the serving dtype) on the same draws, printed, not gated
    g = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(g, cfg, device=DEV)
    a16 = serve.generate(params, prompts, cfg, gen=c["gen"])
    with plain_attention(mods):
        b16 = serve.generate(params, prompts, cfg, gen=c["gen"])
    l16 = a16["prefill_logits"][..., :cfg.vocab]
    log(f"serve bf16 (same draws, same shape): prefill logits max |diff| "
        f"from the fp32 plain route "
        f"{float((l16 - lb).abs().max())!r}, from the bf16 plain route "
        f"{float((l16 - b16['prefill_logits'][..., :cfg.vocab]).abs().max())!r}"
        f"; greedy tokens equal to fp32: "
        f"{bool(torch.equal(a16['generated'], b['generated']))}")
    return {"flash_attention": launches["flash_attention"]}


def active_params(cfg, params) -> int:
    """Parameters a token's matrix products use: every leaf, but of each
    MoE layer's expert stacks the router's top_k of n_experts (the router
    counts whole), and none of the Mamba mixer's element-wise leaves (the
    conv taps and bias, dt_bias, a_log, D).  A dense arch counts every
    leaf."""
    n = 0
    for name, p in _named_leaves(params):
        parent, _, leaf = name.rpartition(".")
        part = parent.rpartition(".")[2]
        if part == "moe" and leaf != "router":
            n += p.numel() * cfg.top_k // cfg.n_experts
        elif part != "mamba" or leaf not in MAMBA_ELEMENTWISE:
            n += p.numel()
    return n


def train_flops(cfg, n_active: int, batch: int, seq: int) -> float:
    """FLOPs of one training step: 6 N per token over the active
    parameters (:func:`active_params`), plus attention's 12 L B S^2 H D
    over the L attention layers (QK^T and PV, forward and backward; causal
    masking not subtracted); the remat forward, the MoE dispatch and the
    Mamba scan's element-wise work are not counted."""
    attn = 12 * _n_attn(cfg) * batch * seq ** 2 * cfg.n_heads * cfg.d_head
    return 6.0 * n_active * batch * seq + attn


def _named_leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _named_leaves(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


def _check_no_launch(counters, what: str) -> None:
    launched = {name: fn.launches for name, fn in counters.items()
                if fn.launches}
    check(not launched, f"{what}: a kernel launched: {launched}")


def _train_drop_shares(torch, mods, params, batch, cfg) -> list:
    """Each MoE layer's share of router choices dropped at capacity over
    the training batch: one forward without autograd (which takes flash)."""
    calls = []
    with recording_moe(mods, calls), torch.no_grad():
        mods["lm"].hidden_forward(params, batch["tokens"], cfg,
                                  batch.get("prefix_embeds"))
    return [1.0 - float(keep.sum()) / keep.numel()
            for _ids, keep, _no_drop, _gap in calls]


def train_full(torch, mods, counters, card: str, cfg, b: int, s: int,
               what: str, lr: float = TRAIN_LR, prefill_len: int = 0,
               grad_check: bool = False) -> dict:
    """4 train steps at peak rate ``lr`` on one fixed batch of ``b`` x
    ``s`` tokens, the bf16 state of ``cfg`` (``grad_check``: the step-1
    gradients first, every leaf finite and non-zero) and a profiler
    window over one more; then a prefill of the trained weights, 2 rows
    of ``prefill_len`` positions (none at 0) with a stub frontend's prefix
    rows in front."""
    tstep, optim = mods["tstep"], mods["optim"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    before = torch.cuda.memory_allocated()
    state = tstep.init_train_state(SEED, cfg, device=DEV)
    # what the state holds on the card, for phase 6 (c)'s dry-run check
    state_alloc = torch.cuda.memory_allocated() - before
    state_tensors = len(mods["tree_leaves"](state.params)
                        + mods["tree_leaves"](state.opt)) + 1   # + step
    n_params = sum(p.numel() for _n, p in _named_leaves(state.params))
    n_active = active_params(cfg, state.params)
    batch = tstep.make_train_batch(
        torch.Generator(device=DEV).manual_seed(SEED), cfg, b, s)
    torch.cuda.synchronize()
    log(f"{what}: state init {time.time() - t0:.3f} s, {n_params} params "
        f"({n_active} active), state {state_alloc / 1e9:.2f} GB on the card "
        f"(reckoned at 16 B a parameter: {16 * n_params / 1e9:.2f} GB)")

    if grad_check:
        # the step-1 gradients: every leaf finite and non-zero
        _loss, _parts, grads = tstep.loss_and_grads(state.params, batch, cfg)
        bad = [name for name, g in _named_leaves(grads)
               if not (bool(torch.isfinite(g).all())
                       and float(g.abs().max()) > 0)]
        check(not bad, f"{what}: step-1 gradient zero or not finite in "
                       f"{bad}")
        log(f"{what}: step-1 gradients of all "
            f"{len(list(_named_leaves(grads)))} leaves finite and non-zero")
        del grads, _loss, _parts
    drops = _train_drop_shares(torch, mods, state.params, batch, cfg) \
        if cfg.n_experts else []
    reset(counters)
    step = tstep.make_train_step(cfg, optim.AdamWConfig(lr=lr),
                                 optim.make_schedule("wsd", TRAIN["steps"]))
    losses, parts, times = [], [], []
    for _ in range(TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # waits for the step
        times.append(time.perf_counter() - t0)
        parts.append((float(metrics["ce"]), float(metrics["aux"])))
    check(all(math.isfinite(x) for x in losses),
          f"{what}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0],
          f"{what}: the loss did not fall from step 1 to step "
          f"{TRAIN['steps']}: {losses}")
    launches = {name: fn.launches for name, fn in counters.items()}
    _check_no_launch(counters, what)
    med = statistics.median(times[1:])
    flops = train_flops(cfg, n_active, b, s)
    peak = torch.cuda.max_memory_allocated()
    out = dict(step_s=med, tokens_per_s=b * s / med, flops=flops,
               mfu=flops / med / PEAK_BF16, peak_gb=peak / 1e9, peak=peak,
               state_alloc=state_alloc, state_tensors=state_tensors,
               losses=losses, parts=parts, times=times, drops=drops,
               launches=launches, params=n_params, active=n_active)
    log(f"{what} {cfg.name} ({cfg.n_layers} layers, bf16, fp32 master/mu/"
        f"nu, remat {cfg.remat}, wsd, lr {lr}, batch {b} x seq {s}): "
        f"losses {losses!r} ((ce, aux) {parts!r}), step times {times!r} s, "
        f"median of steps 2-{TRAIN['steps']} {med!r} s, tokens/s "
        f"{out['tokens_per_s']!r}, MFU {out['mfu']!r} of {PEAK_BF16:.4g} "
        f"FLOP/s dense bf16 (step FLOPs {flops!r} = 6 N_active tokens "
        f"{6.0 * n_active * b * s!r} + attention "
        f"{flops - 6.0 * n_active * b * s!r}; remat not counted), peak "
        f"memory {out['peak_gb']!r} GB, flash launches "
        f"{counters['flash_attention'].launches}"
        + (f", MoE drop share a layer at capacity {cfg.capacity_factor} "
           f"{drops!r}" if drops else "") + f"; card {card}")
    out["profile"] = profile_window(
        torch, f"{what} {cfg.name} step (one more step, batch {b} x seq "
               f"{s})", lambda: step(state, batch), top=14)
    _check_no_launch(counters, f"{what} profiled step")

    if prefill_len:
        # a prefill of the trained weights runs flash "tc"
        reset(counters)
        logits, _cache = tstep.make_prefill_step(cfg)(
            state.params, {k: v[:2, :prefill_len - cfg.prefix_len]
                           if k == "tokens" else v[:2]
                           for k, v in batch.items() if k != "labels"})
        by_route = dict(counters["flash_attention"].launches_by_route)
        want = _n_attn(cfg)
        check(by_route == {"tc": want, "simt": 0},
              f"{what}: prefill of the trained weights launched flash "
              f"{by_route}, not {want} times on \"tc\"")
        check(bool(torch.isfinite(logits).all()) and not logits.requires_grad,
              f"{what}: prefill logits of the trained weights")
        out["prefill_flash"] = want
        log(f"{what}: prefill of the trained {cfg.name} weights (batch 2, "
            f"{prefill_len} positions, {cfg.prefix_len} of them prefix "
            f"rows): flash launches by route {by_route}, logits finite")
        del logits, _cache
    del state, batch
    torch.cuda.empty_cache()
    return out


def _ckpt_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _uninterrupted_losses(torch, mods, job: dict) -> list:
    """The losses of ``job`` run as ``run_training_job`` runs it (its seed,
    state and batch stream, one step after another) in one loop, with no
    job store and no checkpoint."""
    lt, tstep, optim = mods["launch_train"], mods["tstep"], mods["optim"]
    configs = mods["configs"]
    cfg = (configs.get_smoke_config if job["smoke"] else
           configs.get_config)(job["arch"])
    if job["layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=job["layers"])
    seed = lt.stable_seed(job["arch"])
    state = tstep.init_train_state(seed, cfg, device=DEV)
    step = tstep.make_train_step(cfg, optim.AdamWConfig(lr=job["lr"]),
                                 optim.make_schedule("wsd", job["steps"]))
    losses = []
    for i in range(job["steps"]):
        batch = tstep.make_train_batch(lt.step_generator(seed, i, DEV), cfg,
                                       job["batch"], job["seq"])
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    del state
    return losses


def _check_restored(torch, saved_state, back, what: str) -> int:
    """Every leaf of the restored TrainState ``back`` equal bit for bit to
    ``saved_state``'s, of its dtype and device; the leaves kept float32 in
    a bf16 model (the Mamba mixer's a_log and dt_bias) float32 in the
    master copy too.  Returns how many such leaves the params hold."""
    saved = dict(_named_leaves(saved_state._asdict()))
    restored = dict(_named_leaves(back._asdict()))
    check(saved.keys() == restored.keys() and all(
        saved[k].dtype == restored[k].dtype and saved[k].device
        == restored[k].device and torch.equal(saved[k].detach(),
                                              restored[k].detach())
        for k in saved), f"{what}: the restored state differs from the "
                         f"saved one")
    masters = {k[len("opt.master."):]: v for k, v in restored.items()
               if k.startswith("opt.master.")}
    f32 = [k for k, v in restored.items() if masters
           and k.startswith("params.") and v.dtype == torch.float32]
    check(all(masters[k[len("params."):]].dtype == torch.float32
              for k in f32),
          f"{what}: a float32 leaf's master copy is not float32")
    return len(f32)


def train_lifecycle(torch, mods, counters, card: str, job: dict,
                    ckpt_every: int, what: str) -> dict:
    """run_training_job of ``job`` (arch, smoke, layers, batch, seq, lr):
    cancelled after step 2 (by step count), SUSPENDED with an emergency
    checkpoint whose restore is bit-equal; a second call resumes it to
    step 4; the same steps uninterrupted beside it."""
    lt, cancel, store_mod = mods["launch_train"], mods["cancel"], mods["store"]
    steps, half = TRAIN["steps"], TRAIN["steps"] // 2
    job = dict(job, steps=steps, device=DEV)
    reset(counters)
    work = workdir(mods, "train_")
    tok = cancel.CancellationToken()

    def preempt(step: int, _loss: float) -> None:
        if step == half:
            tok.cancel(cancel.CancelReason.PREEMPTION)

    t0 = time.time()
    out1 = lt.run_training_job(workdir=work, ckpt_every=ckpt_every,
                               token=tok, on_step=preempt, **job)
    wall1 = time.time() - t0
    check(out1["final_state"] == "SUSPENDED" and out1["steps_done"] == half,
          f"{what}: first call ended {out1['final_state']} at step "
          f"{out1['steps_done']}")
    store = store_mod.CheckpointStore(os.path.join(work, "ckpt"))
    check(store.latest_step() == half
          and store.manifest(half)["metadata"].get("emergency"),
          f"{what}: no emergency checkpoint at step {half}")
    ckpt_bytes = _ckpt_bytes(os.path.join(store.root, f"step_{half}"))
    t0 = time.time()
    back = lt.restore_train_state(store, half, out1["state"])
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    _check_restored(torch, out1["state"], back, what)
    del out1["state"], back

    t0 = time.time()
    out2 = lt.run_training_job(workdir=work, ckpt_every=ckpt_every, **job)
    wall2 = time.time() - t0
    check(out2["final_state"] == "SUCCEEDED" and out2["steps_done"] == steps
          and out2["job_id"] == out1["job_id"] and "restore_s" in out2,
          f"{what}: the resume ended {out2['final_state']} at step "
          f"{out2['steps_done']} (job {out2['job_id']}, suspended job "
          f"{out1['job_id']})")
    del out2["state"]
    shutil.rmtree(work, ignore_errors=True)
    ref = _uninterrupted_losses(torch, mods, job)
    got = out1["losses"] + out2["losses"]
    rel = max(abs(a - r) / abs(r) for a, r in zip(got, ref))
    check(len(got) == len(ref) and rel <= TRAIN_RESUME_RTOL,
          f"{what}: suspended + resumed losses {got} vs uninterrupted "
          f"{ref} (rel {rel}, limit {TRAIN_RESUME_RTOL})")
    _check_no_launch(counters, what)
    torch.cuda.empty_cache()
    log(f"{what} lifecycle ({job['arch']}, "
        f"{'smoke widths' if job['smoke'] else 'full width'}, "
        f"{job['layers'] or 'all'} layers, batch {job['batch']} x seq "
        f"{job['seq']}): suspended at step {half} "
        f"({wall1:.3f} s), emergency save {out1['save_s']!r} s for "
        f"{ckpt_bytes} bytes, restore {restore_s!r} s (bit-equal, generator "
        f"included), resume to step {steps} {wall2:.3f} s (its restore "
        f"{out2['restore_s']!r} s); losses {got!r} vs uninterrupted "
        f"{ref!r} (max rel {rel!r}); card {card}")
    return dict(save_s=out1["save_s"], restore_s=restore_s,
                ckpt_bytes=ckpt_bytes, rel=rel)


def train_restore_mixed(torch, mods, arch: str, what: str) -> int:
    """``arch``'s smoke config in bf16, one train step, then the state
    through the checkpoint store and ``restore_train_state`` on the card:
    bit-equal, the float32 leaves float32 in the params and the master."""
    tstep, optim, lt = mods["tstep"], mods["optim"], mods["launch_train"]
    cfg = dataclasses.replace(mods["configs"].get_smoke_config(arch),
                              dtype="bfloat16")
    state = tstep.init_train_state(SEED, cfg, device=DEV)
    batch = tstep.make_train_batch(
        torch.Generator(device=DEV).manual_seed(SEED), cfg,
        FAMILY_LIFECYCLE_JOB["batch"], FAMILY_LIFECYCLE_JOB["seq"])
    state, _ = tstep.make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR))(
        state, batch)
    store = mods["store"].CheckpointStore(workdir(mods, "mixed_"))
    store.save(1, state)
    back = lt.restore_train_state(
        store, 1, tstep.init_train_state(SEED + 1, cfg, device=DEV))
    n = _check_restored(torch, state, back, f"{what} bf16")
    check(n > 0 or cfg.family not in ("ssm", "hybrid"),
          f"{what} bf16: no float32 leaf in the restored params")
    shutil.rmtree(store.root, ignore_errors=True)
    log(f"{what}: {cfg.name} in bf16 after a step, saved and restored on "
        f"the card bit-equal; {n} float32 leaves in the bf16 params, their "
        f"masters float32")
    return n


def _compare_routing(card_calls, host_calls, what: str) -> None:
    """Every MoE call's router ids and keep mask equal, card against host;
    a flip prints the nearest top-k tie of that input on the host."""
    check(len(card_calls) == len(host_calls),
          f"{what}: {len(card_calls)} MoE calls on the card, "
          f"{len(host_calls)} on the host")
    for i, ((ci, ck, _nd, _cg), (hi, hk, _hnd, hgap)) in enumerate(
            zip(card_calls, host_calls)):
        flips = int((ci.cpu() != hi).sum())
        check(flips == 0,
              f"{what}: MoE call {i}: router ids differ at {flips} choices; "
              f"the nearest top-k tie of that input is {hgap!r} apart on "
              f"the host")
        check(bool(ck.cpu().equal(hk)),
              f"{what}: MoE call {i}: keep masks differ")


def train_grad_check(torch, mods, counters, cfg, what: str) -> dict:
    """Gradients of ``cfg`` in fp32, card against host, on the same params
    and tokens: every MoE call's routing equal, then every gradient leaf
    within TRAIN_GRAD_TOL of its largest |g| and the loss within
    SERVE_LOGIT_RTOL relative."""
    tstep, lm = mods["tstep"], mods["lm"]
    tree_map = mods["tree_map"]
    c = TRAIN_GRAD_CHECK
    # drawn on the card (a host draw of a full-width layer takes seconds)
    card_params = tstep.as_trainable(lm.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg, device=DEV))
    host = tstep.as_trainable(tree_map(lambda p: p.detach().cpu(),
                                       card_params))
    # c["seq"] text tokens after a stub frontend's prefix rows
    batch = tstep.make_train_batch(torch.Generator().manual_seed(SEED + 1),
                                   cfg, c["batch"], c["seq"] + cfg.prefix_len)
    reset(counters)
    card_calls, host_calls = [], []
    t0 = time.time()
    with recording_moe(mods, card_calls):
        loss_c, _, g_c = tstep.loss_and_grads(
            card_params, {k: v.to(DEV) for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    t0 = time.time()
    with recording_moe(mods, host_calls):
        loss_h, _, g_h = tstep.loss_and_grads(host, batch, cfg)
    host_s = time.time() - t0
    _check_no_launch(counters, what)
    _compare_routing(card_calls, host_calls, what)
    worst = {}
    for (name, a), (_n, b) in zip(_named_leaves(g_c), _named_leaves(g_h)):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        check(scale > 0 and err <= TRAIN_GRAD_TOL * scale,
              f"{what}: gradient of {name} differs by {err} on the card "
              f"(largest |g| {scale}, limit {TRAIN_GRAD_TOL} of it)")
        worst[name] = err / scale
    loss_c, loss_h = float(loss_c.detach()), float(loss_h.detach())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    check(rel <= SERVE_LOGIT_RTOL,
          f"{what}: loss {loss_c} on the card, {loss_h} on the host (rel "
          f"{rel}, limit {SERVE_LOGIT_RTOL})")
    gap = min((call[3] for call in host_calls), default=None)
    log(f"{what} gradient check ({cfg.name}, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, fp32, batch {c['batch']} x seq {c['seq']})"
        f": loss card {loss_c!r} host {loss_h!r} (rel {rel!r}); gradient max"
        f" |diff| / max |g| per leaf {worst!r}"
        + (f"; {len(card_calls)} MoE calls with equal router ids and keep "
           f"masks, nearest top-k tie {gap!r} apart" if host_calls else "")
        + f"; card {card_s:.3f} s, host {host_s:.3f} s")
    del host, card_params, g_c, g_h
    torch.cuda.empty_cache()
    return dict(worst=max(worst.values()), loss_rel=rel)


def train_bits(torch, mods, counters, cfg, what: str) -> dict:
    """The step-1 loss and gradients of ``cfg`` (bf16) computed twice from
    the same params and batch: every leaf finite, non-zero and equal bit
    for bit across the two runs."""
    tstep, lm = mods["tstep"], mods["lm"]
    b, s = TRAIN_BITS["batch"], TRAIN_BITS["seq"]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    params = tstep.as_trainable(lm.init_params(gen, cfg, device=DEV))
    batch = tstep.make_train_batch(gen, cfg, b, s)
    reset(counters)
    runs = []
    for _ in range(2):
        loss, _parts, grads = tstep.loss_and_grads(params, batch, cfg)
        runs.append((loss.detach(), dict(_named_leaves(grads))))
        del grads
    torch.cuda.synchronize()
    _check_no_launch(counters, what)
    (l1, g1), (l2, g2) = runs
    bad = [name for name, g in g1.items()
           if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    check(not bad, f"{what}: step-1 gradient zero or not finite in {bad}")
    differ = [name for name in g1 if not torch.equal(g1[name], g2[name])]
    check(not differ and torch.equal(l1, l2),
          f"{what}: two runs differ in the loss ({float(l1)!r} vs "
          f"{float(l2)!r}) or at {len(differ)} of {len(g1)} gradient "
          f"leaves: {differ}")
    log(f"{what} run-to-run bits ({cfg.name}, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, bf16, batch {b} x seq {s}"
        + (f", top-{cfg.top_k} of {cfg.n_experts} experts"
           if cfg.n_experts else "")
        + f"): loss {float(l1)!r} and all {len(g1)} gradient leaves bitwise "
          f"equal across two runs, every leaf finite and non-zero")
    n = len(g1)
    del params, batch, runs, g1, g2
    torch.cuda.empty_cache()
    return dict(leaves=n)


def training_path(torch, mods, counters, card: str) -> dict:
    """Slice 9's path: LM training (phase 3d (a)-(c))."""
    configs = mods["configs"]
    cfg = configs.get_config(TRAIN["arch"])
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    t0 = time.time()
    full = train_full(torch, mods, counters, card, cfg, TRAIN["batch"],
                      TRAIN["seq"], "train (a)", prefill_len=1024,
                      grad_check=True)
    life = train_lifecycle(
        torch, mods, counters, card,
        dict(arch=TRAIN["arch"], smoke=False, layers=TRAIN_CUT_LAYERS,
             batch=TRAIN["batch"], seq=TRAIN["seq"], lr=TRAIN_LR),
        TRAIN["steps"] // 2, "train (b)")
    grads = train_grad_check(torch, mods, counters,
                             dataclasses.replace(cut, dtype="float32"),
                             "train (c)")
    log(f"train phase 3d: {time.time() - t0:.1f} s wall")
    return dict(full=full, lifecycle=life, grads=grads,
                launches=full["launches"])


def _launch_counts(counters, names=("assign_clusters", "lloyd_sums",
                                    "epsilon_degree", "expand_frontier")
                   ) -> dict:
    return {name: counters[name].launches for name in names}


def examples_quickstart_mine(torch, mods, counters) -> dict:
    """5 (a): ``quickstart`` and ``mine_cluster`` on the card, each result
    equal to the same call with the plain versions."""
    qs, mc = mods["ex_quickstart"], mods["ex_mine_cluster"]
    reset(counters)
    t0 = time.time()
    out = qs.main(["--device", DEV])
    torch.cuda.synchronize()
    wall_qs = time.time() - t0
    qs_launches = _launch_counts(counters)
    kres, dres, x = out["kmeans"], out["dbscan"], out["x"]
    check(qs_launches["assign_clusters"] == int(kres.iterations) >= 1
          and qs_launches["lloyd_sums"] == int(kres.iterations),
          f"quickstart: {qs_launches['assign_clusters']} assignment and "
          f"{qs_launches['lloyd_sums']} narrow-row sums launches for "
          f"{int(kres.iterations)} iterations")
    check(qs_launches["epsilon_degree"] == 1
          and qs_launches["expand_frontier"] == int(dres.expansions) >= 1,
          f"quickstart: DBSCAN launches {qs_launches} for "
          f"{int(dres.expansions)} expansions")
    reset(counters)
    kp = qs.run_kmeans(x, qs.SPEC.clusters, use_kernel=False)
    dp = qs.run_dbscan(x, qs.SPEC.features, use_kernel=False)
    _check_no_launch(counters, "quickstart with the plain versions")
    check(bool(torch.equal(kres.labels, kp.labels))
          and int(kres.iterations) == int(kp.iterations),
          f"quickstart K-Means: labels or iterations ({int(kres.iterations)}"
          f" vs {int(kp.iterations)}) differ from the plain versions")
    check(bool(torch.equal(dres.labels, dp.labels))
          and int(dres.n_clusters) == int(dp.n_clusters)
          and int(dres.expansions) == int(dp.expansions),
          "quickstart DBSCAN: labels, clusters or expansions differ from "
          "the plain versions")
    log(f"examples quickstart: {wall_qs:.3f} s; K-Means {int(kres.iterations)}"
        f" iterations, DBSCAN {int(dres.n_clusters)} clusters in "
        f"{int(dres.expansions)} expansions, both equal to the plain "
        f"versions; launches {qs_launches}")

    work = workdir(mods, "ex_mine_")
    reset(counters)
    t0 = time.time()
    out = mc.main(["--device", DEV, "--workdir", work])
    torch.cuda.synchronize()
    wall_mc = time.time() - t0
    mc_launches = _launch_counts(counters)
    reset(counters)
    plain = mc.run_grid(workdir(mods, "ex_mine_plain_"), DEV,
                        use_kernel=False)
    _check_no_launch(counters, "mine_cluster with the plain versions")
    iters = sum(o["iterations"] for o in out["grid"] if o["algo"] == "kmeans")
    expansions = sum(o["expansions"] for o in out["grid"]
                     if o["algo"] == "dbscan")
    for o, p in zip(out["grid"], plain, strict=True):
        check(o["final_state"] == "SUCCEEDED", f"mine_cluster: {o}")
        same = bool(torch.equal(o["labels"], p["labels"]))
        for key in (("iterations",) if o["algo"] == "kmeans"
                    else ("n_clusters", "expansions")):
            same = same and o[key] == p[key]
        check(same, f"mine_cluster {o['algo']} job {o['job_id']}: differs "
                    f"from the plain versions")
    canc = out["cancelled"]
    check((canc["final_state"], canc["cancelled"]) in
          (("SUSPENDED", True), ("SUCCEEDED", False)),
          f"mine_cluster cancelled job: {canc['final_state']} with "
          f"cancelled={canc['cancelled']}")
    cancel_expansions = canc["expansions"]
    states = [j.state.value for j in out["jobs"]]
    check(states == ["SUCCEEDED"] * len(plain) + [canc["final_state"]],
          f"mine_cluster job store read back {states}")
    check(mc_launches["assign_clusters"] == iters
          and mc_launches["lloyd_sums"] == iters
          and mc_launches["epsilon_degree"] == len(mc.GRID) + 1
          and mc_launches["expand_frontier"]
          == expansions + cancel_expansions,
          f"mine_cluster: launches {mc_launches} for {iters} iterations and "
          f"{expansions} + {cancel_expansions} expansions")
    log(f"examples mine_cluster: {wall_mc:.3f} s; {len(plain)} grid jobs "
        f"equal to the plain versions; the cancel "
        f"{'landed' if canc['cancelled'] else 'came after the job ended'}"
        f" ({canc['final_state']} after {canc['wall_s']:.3f} s); launches "
        f"{mc_launches}")
    return {k: qs_launches[k] + mc_launches[k] for k in qs_launches}


def examples_service_demo(torch, mods, counters) -> dict:
    """5 (b): ``service_demo`` on the card, then the reopened stream's
    ``assign`` on the card against the plain assignment.

    The demo itself launches no kernel: its requests of acts 1-3 are small
    work, which the cost model's small-work rule (``dispatch.
    SMALL_WORK_THRESHOLD``) sends to the ``numpy-mt`` host lane, as the
    reference's does; act 4 pins ``torch-ref``; the stream learns with the
    plain versions (``StreamingSession.push``).  The lanes are checked, so
    a change of routing shows; the one launch is the ``assign`` added here.
    """
    sd, service, dref = (mods["ex_service_demo"], mods["service"],
                         mods["dref"])
    work = workdir(mods, "ex_svc_")
    reset(counters)
    t0 = time.time()
    out = sd.run(work, DEV)
    wall = time.time() - t0
    check(len(out["results"]) == 5
          and all(r is not None and r["labels"] is not None
                  for r in out["results"]),
          "service_demo: a handle did not resolve")
    check(out["cache_hit"], "service_demo: the repeated dataset missed the "
                            "cache")
    check(out["stream_intact"]
          and out["stream_after"]["step"] == out["stream_before"]["step"],
          "service_demo: the reopened stream's centroids differ")
    if out["finished_first"]:
        outcome = "the batch finished before the preemption landed"
    else:
        check(len(out["resumed"]) == 1 and not out["resumed"][0].suspended,
              f"service_demo: the preempted batch resumed as "
              f"{out['resumed']}")
        outcome = f"preempted and resumed on {out['resumed'][0].executor}"
    lanes = {n: st["batches"] for n, st in out["metrics"]["lanes"].items()
             if st["batches"]}
    # acts 1-3 are small work: the cost model's little class
    # (SMALL_WORK_THRESHOLD) puts them on the host lane, as the reference
    # does; act 4 pins torch-ref.  Neither launches a kernel.
    check(set(out["lanes_acts_1_3"]) == {"numpy-mt"}
          and set(lanes) == {"torch-ref"},
          f"service_demo: lanes acts 1-3 {out['lanes_acts_1_3']}, act 4 "
          f"{lanes}; expected numpy-mt, then torch-ref")
    session = service.StreamingSession(
        os.path.join(work, "streams"), sd.STREAM["tenant"],
        sd.STREAM["name"], k=sd.STREAM["k"],
        batch_size=sd.STREAM["batch_size"], device=DEV)
    points = sd.dataset(24, clusters=3, points=48)
    labels = session.assign(points)
    launches = _launch_counts(counters)
    check(launches["assign_clusters"] == 1,
          f"service_demo: stream.assign made "
          f"{launches['assign_clusters']} assignment launches, not 1")
    ridx, _ = dref.assign_clusters_ref(
        torch.as_tensor(points, device=DEV), session.state.centroids)
    check(bool((torch.as_tensor(labels).long() == ridx.cpu().long()).all()),
          "service_demo: stream.assign on the card differs from "
          "assign_clusters_ref")
    log(f"examples service_demo: {wall:.3f} s; 5 handles resolved, cache "
        f"hit, stream reopened at step {out['stream_after']['step']} with "
        f"its centroids bit-equal; {outcome}; lanes acts 1-3 "
        f"{out['lanes_acts_1_3']}, act 4 {lanes}; stream.assign of "
        f"{len(points)} points equal to assign_clusters_ref; launches "
        f"{launches}")
    return launches


def examples_embedding(torch, mods, counters, card: str) -> tuple:
    """5 (c)-(d): embedding clustering at OLMo-1B's full width and depth
    through the example's functions, and the assignment kernel's row at
    its shape (n = docs, d = 2048, k = 4: the wide search)."""
    ec, configs, kmeans = (mods["ex_embedding"], mods["configs"],
                           mods["kmeans"])
    dops, dref = mods["dops"], mods["dref"]
    cfg = configs.get_config(EMBED["arch"])
    docs, seq, k = EMBED["docs"], EMBED["seq"], EMBED["k"]
    torch.cuda.empty_cache()
    params = ec.init_model(cfg, DEV, seed=SEED)
    toks = ec.random_tokens(cfg, docs, seq, DEV, seed=SEED + 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.time()
    emb, logits = ec.embed_documents(params, toks, cfg)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    flash = counters["flash_attention"]
    check(flash.launches == cfg.n_layers
          and flash.launches_by_route["tc"] == cfg.n_layers,
          f"embedding forward: flash launches {flash.launches} "
          f"{flash.launches_by_route}, not {cfg.n_layers} on \"tc\"")
    check(tuple(logits.shape) == (docs, seq, cfg.vocab_padded),
          f"embedding forward: logits {tuple(logits.shape)}")
    rows = logits.view(-1, logits.shape[-1])
    finite = all(bool(torch.isfinite(rows[i:i + 8192]).all())
                 for i in range(0, rows.shape[0], 8192))
    check(finite, "embedding forward: a logit is not finite")
    logits_bytes = logits.numel() * logits.element_size()
    del logits, rows
    torch.cuda.empty_cache()
    check(tuple(emb.shape) == (docs, cfg.d_model)
          and emb.dtype == torch.float32
          and bool(torch.isfinite(emb).all()),
          f"embedding: pooled points {tuple(emb.shape)} {emb.dtype}")
    t0 = time.time()
    res = ec.cluster(emb, k, seed=SEED + 2)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = {"flash_attention": flash.launches,
                "assign_clusters": counters["assign_clusters"].launches}
    check(launches["assign_clusters"] == int(res.iterations) >= 1,
          f"embedding fit: {launches['assign_clusters']} assignment launches "
          f"for {int(res.iterations)} iterations")
    reset(counters)
    plain = ec.cluster(emb, k, seed=SEED + 2, use_kernel=False)
    _check_no_launch(counters, "embedding fit with the plain versions")
    check(bool(torch.equal(res.labels, plain.labels))
          and int(res.iterations) == int(plain.iterations),
          f"embedding fit: labels or iterations ({int(res.iterations)} vs "
          f"{int(plain.iterations)}) differ from the plain versions")
    sizes = torch.bincount(res.labels.long(), minlength=k).tolist()
    log(f"examples embedding clustering: {cfg.name} {cfg.n_layers} layers "
        f"d_model {cfg.d_model} {cfg.dtype}, {docs} documents x {seq} "
        f"tokens; forward {fwd_s:.3f} s ({launches['flash_attention']} "
        f"flash launches, all \"tc\"; logits finite, {logits_bytes} "
        f"bytes), peak memory "
        f"{peak / 1e9:.3f} GB ({base / 1e9:.3f} GB before the forward); "
        f"fit {fit_s:.3f} s, {int(res.iterations)} iterations, sizes "
        f"{sizes}, inertia {float(res.inertia)!r}; labels and iterations "
        f"equal to the plain versions; card {card}")

    # (d) the assignment kernel at the fit's shape and first centroids
    c0 = kmeans.init_centroids(
        SEED + 2, emb, kmeans.KMeansConfig(k=k, init="kmeans++"))
    n, d = emb.shape
    check(dops.plan(n, k, d).wide, f"assignment n={n} d={d} k={k}: the plan "
                                   f"did not take the wide search")
    idx, dist = dops.assign_clusters(emb, c0)
    ridx, rdist = dref.assign_clusters_ref(emb, c0)
    torch.cuda.synchronize()
    check(bool(torch.equal(idx, ridx)) and same_bits(torch, dist, rdist),
          f"assignment n={n} d={d} k={k} (wide): differs from the plain "
          f"version")
    err = float((dist - rdist).abs().max())
    rechecks = recheck_line(dops, dops.assign_clusters,
                            f"assignment n={n} d={d} k={k} (embedding)", n)
    # at this size the event mean over queued calls reads the host's rate
    # of calls, so the row's times are device times of one call (a CUDA
    # graph's replays), the kernel's and the library call's alike; the
    # event means and the host's time a call are logged beside them
    def assign():
        return dops.assign_clusters(emb, c0)

    def library():
        return torch.cdist(emb, c0).argmin(1)

    events = time_ms(torch, assign, reps=50)
    ms = graph_ms(torch, assign)
    host = host_us(torch, assign)
    plain_ms = time_ms(torch, lambda: dref.assign_clusters_ref(emb, c0),
                       reps=20)
    lib_events = time_ms(torch, library, reps=50)
    lib = graph_ms(torch, library)
    lib_host = host_us(torch, library)
    b, by = bound(n * d * 4 + k * d * 4 + n * 8, 3 * 2.0 * n * k * d,
                  PEAK_TF32)
    b32, _ = bound(n * d * 4 + k * d * 4 + n * 8, 2.0 * n * k * d)
    log(f"assignment n={n} d={d} k={k} (wide, the embedding fit's shape): "
        f"indices and distances bit-identical; device {ms!r} ms a call "
        f"(the first wide form, on an H100 at 700 W: 0.6022), queued "
        f"calls {events!r} ms, host {host!r} us a call; plain "
        f"{plain_ms!r}; cdist device {lib!r} ms, queued {lib_events!r} ms, "
        f"host {lib_host!r} us; bound {b!r} ({by})")
    row = dict(name="assign_clusters_d2048", route="cuda",
               source="src/repro_torch/csrc/distance.cu",
               replaces="src/repro/kernels/distance/distance.py:46",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, library_ms=lib, bound_fp32_ms=b32,
               library_call="cdist(x, c).argmin(1)",
               shape=f"n={n} d={d} k={k} (wide)", rechecks=rechecks,
               events_ms=events, host_us=host,
               library_events_ms=lib_events, library_host_us=lib_host,
               search=search_line(dops, n, k, d, emb.device))
    # where the forward's time goes: one more forward, after the counts
    profile_window(torch, f"embedding forward ({docs} x {seq} tokens)",
                   lambda: ec.embed_documents(params, toks, cfg), top=8)
    del params, emb
    torch.cuda.empty_cache()
    return launches, row


def examples_path(torch, mods, counters, card: str) -> tuple:
    """Slice 10's path (phase 5): the four tour examples on the card."""
    t0 = time.time()
    launches = examples_quickstart_mine(torch, mods, counters)
    svc = examples_service_demo(torch, mods, counters)
    emb, row = examples_embedding(torch, mods, counters, card)
    for name, v in list(svc.items()) + list(emb.items()):
        launches[name] = launches.get(name, 0) + v
    log(f"examples phase 5: {time.time() - t0:.1f} s wall, launches "
        f"{launches}")
    return launches, row, emb["assign_clusters"]


# ---------------------------------------------------------------------------
# Phase 3e: the MoE, Mamba, hybrid and stub-frontend archs served
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording_moe(mods, calls: list):
    """Every MoE sub-layer the decoder runs in the block also records what
    its router decided (``moe.routing`` on the same input) and how near
    its nearest tie was: (ids, keep, no_drop, gap) appended to ``calls``,
    gap the smallest difference over tokens between the k-th and (k+1)-th
    router probability.  The package has no hook for it."""
    lm, moe = mods["lm"], mods["moe"]
    saved = lm.moe_ffn

    def recorded(params, x, cfg, *, no_drop=False):
        # outside autograd: a training step records the same decisions
        plain = {k: v.detach() for k, v in params.items()}
        ids, keep = moe.routing(plain, x.detach(), cfg, no_drop=no_drop)
        top = moe.route(plain, x.detach(), cfg)[0].sort(dim=-1,
                                                        descending=True)[0]
        k = cfg.top_k
        gap = (float((top[..., k - 1] - top[..., k]).min())
               if k < top.shape[-1] else float("inf"))
        calls.append((ids, keep, no_drop, gap))
        return saved(params, x, cfg, no_drop=no_drop)

    lm.moe_ffn = recorded
    try:
        yield
    finally:
        lm.moe_ffn = saved


def _n_attn(cfg) -> int:
    """Attention sub-layers in the config's depth: one flash launch each
    in a prefill."""
    return cfg.n_groups * sum(m == "attn" for m, _ff in cfg.pattern)


def _check_served(torch, counters, what, out, cfg, batch, gen) -> dict:
    """One serving run's checks: flash once per attention layer of the
    prefill, all on "tc", none in decode, no mining kernel; logits finite;
    every token in the vocabulary.  Returns the launch counts."""
    launches = {name: fn.launches for name, fn in counters.items()}
    by_route = dict(counters["flash_attention"].launches_by_route)
    want = _n_attn(cfg)
    check(launches["flash_attention"] == want
          and by_route == {"tc": want, "simt": 0},
          f"{what}: flash launches {launches['flash_attention']} by route "
          f"{by_route}; want {want} (one per attention layer of the "
          f"prefill, none in decode), all \"tc\"")
    check(all(n == 0 for name, n in launches.items()
              if name != "flash_attention"),
          f"{what}: a mining kernel launched: {launches}")
    check(out["logits_finite"], f"{what}: a logit is not finite")
    toks = out["generated"]
    check(toks is not None and tuple(toks.shape) == (batch, gen),
          f"{what}: generated {None if toks is None else tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{what}: a token outside the vocabulary")
    return launches


def _prefix_run(torch, mods, counters, params, cfg, card) -> None:
    """A stub-frontend arch's prefill with its prefix: prefix_len rows of
    ``synthetic_prefix`` ahead of SERVE_WIDE prompt - prefix_len tokens,
    then SERVE_PREFIX_GEN decode steps at the positions that follow."""
    lm, frontends = mods["lm"], mods["frontends"]
    b, p = SERVE_WIDE["batch"], SERVE_WIDE["prompt_len"]
    n = SERVE_PREFIX_GEN
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    pe = frontends.synthetic_prefix(g, cfg, b)
    toks = torch.randint(0, cfg.vocab, (b, p - cfg.prefix_len), generator=g,
                         device=DEV)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = lm.prefill_step(params, toks, cfg, max_seq=p + n,
                                    prefix_embeds=pe)
    finite = torch.isfinite(logits).all()
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    out = []
    for i in range(n):
        tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        out.append(tok)
        logits, cache = lm.decode_step(params, cache, tok, p + i, cfg)
        finite &= torch.isfinite(logits).all()
    res = {"generated": torch.cat(out, dim=1), "logits_finite": bool(finite)}
    _check_served(torch, counters, f"{cfg.name} with its prefix", res, cfg,
                  b, n)
    log(f"serve {cfg.name} with its {cfg.frontend} prefix: "
        f"{cfg.prefix_len} prefix rows + {p - cfg.prefix_len} tokens, "
        f"prefill {prefill_s!r} s, {n} decode steps, "
        f"{_n_attn(cfg)} flash launches all \"tc\", logits finite; "
        f"card {card}")


def _group_cosine(torch, x, group: int) -> float:
    """The mean cosine over pairs of distinct tokens within a dispatch
    group, x (B, S, d): per group, |sum of unit rows|^2 = G + that sum over
    the G (G - 1) ordered pairs."""
    b, s, d = x.shape
    u = torch.nn.functional.normalize(x.float(), dim=-1)
    tot = u.reshape(b * (s // group), group, d).sum(1).square().sum(-1)
    return float(((tot - group) / (group * (group - 1))).mean())


def _drop_share(torch, mods, params, cfg) -> tuple:
    """The share of token choices dropped at capacity in a prefill of the
    timed run's shape, and for each MoE layer its own share, the mean
    pairwise cosine of its router inputs within a dispatch group (the
    token embeddings' in front) and its top-1 expert histogram (logged,
    not gated)."""
    lm, moe = mods["lm"], mods["moe"]
    g = torch.Generator(device=DEV).manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab, (SERVE_WIDE["batch"],
                                        SERVE_WIDE["prompt_len"]),
                         generator=g, device=DEV)
    group, _cap = moe.grouping(cfg, toks.shape[1], False)
    layers = []
    saved = lm.moe_ffn

    def recorded(params, x, cfg, *, no_drop=False):
        ids, keep = moe.routing(params, x, cfg, no_drop=no_drop)
        layers.append(dict(
            kept=int(keep.sum()), total=keep.numel(),
            cosine=_group_cosine(torch, x, group),
            top1=torch.bincount(ids[..., 0].flatten(),
                                minlength=cfg.n_experts).tolist()))
        return saved(params, x, cfg, no_drop=no_drop)

    lm.moe_ffn = recorded
    try:
        lm.prefill_step(params, toks, cfg)
    finally:
        lm.moe_ffn = saved
    kept = sum(ly["kept"] for ly in layers)
    total = sum(ly["total"] for ly in layers)
    stats = dict(group=group, layers=layers, embed_cosine=_group_cosine(
        torch, params["embed"][toks], group))
    n = toks.numel()
    log(f"{cfg.name} prefill routing (batch {toks.shape[0]}, prompt "
        f"{toks.shape[1]}, groups of {group}): token embeddings' mean "
        f"pairwise cosine within a group {stats['embed_cosine']!r}; per MoE "
        f"layer: drop share, router inputs' mean pairwise cosine within a "
        f"group, top-1 experts used of {cfg.n_experts}, largest top-1 share: "
        + "; ".join(f"{i}: {1 - ly['kept'] / ly['total']:.4f} "
                    f"{ly['cosine']:.4f} {sum(c > 0 for c in ly['top1'])} "
                    f"{max(ly['top1']) / n:.4f}"
                    for i, ly in enumerate(layers)))
    log(json.dumps({"moe_routing": cfg.name, **stats}))
    return 1.0 - kept / total, stats


def _profile_arch(torch, mods, params, cfg) -> dict:
    """Where one arch's serving time goes: a prefill at SERVE_WIDE's shape
    and SERVE_PROFILE_STEPS decode steps, each under the profiler."""
    lm = mods["lm"]
    b, p, n = SERVE_WIDE["batch"], SERVE_WIDE["prompt_len"], \
        SERVE_PROFILE_STEPS
    g = torch.Generator(device=DEV).manual_seed(SEED + 9)
    toks = torch.randint(0, cfg.vocab, (b, p), generator=g, device=DEV)
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill_step(params, toks, cfg,
                                                          max_seq=p + n)

    def decode():
        logits, cache = state["logits"], state["cache"]
        for i in range(n):
            tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            logits, cache = lm.decode_step(params, cache, tok, p + i, cfg)

    out = {"prefill": profile_window(torch, f"{cfg.name} prefill (batch {b}, "
                                            f"prompt {p})", prefill),
           "decode": profile_window(torch, f"{cfg.name} decode ({n} steps, "
                                           f"batch {b})", decode)}
    del state
    return {k: dict(wall_ms=v["wall_ms"], busy_ms=v["busy_ms"])
            for k, v in out.items()}


def serve_wide_arch(torch, mods, counters, arch, layers, card) -> dict:
    """One arch at its published width (depth ``layers``, or all), bf16,
    synthetic weights: SERVE_WIDE through ``serve.serve_batch`` (or, at a
    cut depth, ``lm.init_params`` + ``serve.generate`` on the cut config),
    then the prefix run (stub frontends) and the drop share (MoE)."""
    serve, lm, configs = mods["serve"], mods["lm"], mods["configs"]
    full = configs.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    b, p, n = SERVE_WIDE["batch"], SERVE_WIDE["prompt_len"], SERVE_WIDE["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = None
    reset(counters)
    t0 = time.time()
    if layers is None:
        out = serve.serve_batch(arch=arch, smoke=False, device=DEV,
                                seed=SEED, **SERVE_WIDE)
    else:
        g = torch.Generator(device=DEV).manual_seed(SEED)
        params = lm.init_params(g, cfg, device=DEV)
        prompts = torch.randint(0, cfg.vocab, (b, p), generator=g,
                                device=DEV)
        out = serve.generate(params, prompts, cfg, gen=n)
    wall = time.time() - t0
    launches = _check_served(torch, counters, f"serve {arch}", out, cfg, b, n)
    peak = torch.cuda.max_memory_allocated()
    line = dict(arch=arch, layers=cfg.n_layers, of_layers=full.n_layers,
                prefill_s=out["prefill_s"],
                decode_ms=out["decode_s"] / n * 1e3,
                tokens_per_s=out["tokens_per_s"], wall_s=wall,
                peak_gb=peak / 1e9, flash=launches["flash_attention"],
                params=cfg.n_params())
    del out
    if params is None:
        params = lm.init_params(torch.Generator(device=DEV).manual_seed(SEED),
                                cfg, device=DEV)
    line["profile"] = _profile_arch(torch, mods, params, cfg)
    if cfg.frontend != "none":
        _prefix_run(torch, mods, counters, params, cfg, card)
    if cfg.n_experts:
        line["dropped_share"], line["routing"] = _drop_share(
            torch, mods, params, cfg)
    log(f"serve {arch} published width, {cfg.n_layers} of {full.n_layers} "
        f"layers, {cfg.n_params() / 1e9:.2f} B weights bf16 (batch {b}, "
        f"prompt {p}, gen {n}): prefill_s {line['prefill_s']!r}, "
        f"{line['decode_ms']!r} ms per decode token, tokens_per_s "
        f"{line['tokens_per_s']!r}, wall with weight init {wall:.3f} s, "
        f"peak memory {line['peak_gb']:.3f} GB, flash launches "
        f"{line['flash']} all \"tc\", logits finite"
        + (f", MoE choices dropped at capacity in the prefill "
           f"{line['dropped_share']!r}" if cfg.n_experts else "")
        + f"; card {card}")
    del params
    torch.cuda.empty_cache()
    return line


def serve_twin(torch, mods, arch, card) -> None:
    """Card against host in fp32 for one family: one layer group at the
    published width (jamba: its smoke config, one whole period), the same
    weights and prompts, SERVE_TWIN; prefill logits within
    SERVE_LOGIT_RTOL of the largest |logit|, greedy tokens equal, and for
    MoE every layer's router ids and keep mask equal."""
    serve, lm, configs, tree_map = (mods["serve"], mods["lm"],
                                    mods["configs"], mods["tree_map"])
    if arch == "jamba-v0.1-52b":
        cfg = configs.get_smoke_config(arch)
    else:
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, dtype="float32", n_layers=full.period)
    b, p, n = SERVE_TWIN["batch"], SERVE_TWIN["prompt_len"], SERVE_TWIN["gen"]
    torch.cuda.empty_cache()
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    params = lm.init_params(g, cfg, device=DEV)
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=g, device=DEV)
    card_calls, host_calls = [], []
    with recording_moe(mods, card_calls):
        a = serve.generate(params, prompts, cfg, gen=n)
    host = tree_map(lambda t: t.cpu(), params)
    t0 = time.time()
    with recording_moe(mods, host_calls):
        h = serve.generate(host, prompts.cpu(), cfg, gen=n)
    host_s = time.time() - t0
    la = a["prefill_logits"][..., :cfg.vocab].cpu()
    lh = h["prefill_logits"][..., :cfg.vocab]
    diff = float((la - lh).abs().max())
    scale = float(lh.abs().max())
    check(a["logits_finite"] and h["logits_finite"],
          f"{arch} card vs host: a logit is not finite")
    check(diff <= SERVE_LOGIT_RTOL * scale,
          f"{arch} card vs host: prefill logits differ by {diff} (largest "
          f"|logit| {scale}, limit {SERVE_LOGIT_RTOL} relative)")
    check(len(card_calls) == len(host_calls),
          f"{arch} card vs host: {len(card_calls)} MoE calls on the card, "
          f"{len(host_calls)} on the host")
    for i, ((ci, ck, _nd, _cg), (hi, hk, _hnd, hgap)) in enumerate(
            zip(card_calls, host_calls)):
        flips = int((ci.cpu() != hi).sum())
        check(flips == 0,
              f"{arch} card vs host: MoE call {i}: router ids differ at "
              f"{flips} choices; the nearest top-k tie of that input is "
              f"{hgap!r} apart on the host")
        check(bool(torch.equal(ck.cpu(), hk)),
              f"{arch} card vs host: MoE call {i}: keep masks differ")
    check(bool(torch.equal(a["generated"].cpu(), h["generated"])),
          f"{arch} card vs host: greedy tokens differ")
    gap = min((c[3] for c in host_calls), default=None)
    kept = sum(int(c[1].sum()) for c in host_calls if not c[2])
    total = sum(c[1].numel() for c in host_calls if not c[2])
    log(f"serve card vs host fp32 {cfg.name} ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}; batch {b}, prompt {p}, gen {n}): prefill "
        f"logits max |diff| {diff!r} of largest |logit| {scale!r} (rel "
        f"{diff / scale!r}), {n} greedy tokens equal"
        + (f", {len(card_calls)} MoE calls with equal router ids and keep "
           f"masks ({total - kept} of {total} prefill choices dropped), "
           f"nearest top-k tie {gap!r} apart"
           if cfg.n_experts else "")
        + f"; host {host_s:.2f} s; card {card}")
    del params, host, a, h
    torch.cuda.empty_cache()


def lm_families_path(torch, mods, counters, card: str) -> dict:
    """Slices 11 and 14's path (phase 3e): the six archs of the MoE, Mamba,
    hybrid and stub-frontend families and the three other dense archs
    served at published width, then each card against host in fp32."""
    t0 = time.time()
    lines = {arch: serve_wide_arch(torch, mods, counters, arch, layers, card)
             for arch, layers in SERVE_FAMILIES}
    for arch, _layers in SERVE_FAMILIES:
        serve_twin(torch, mods, arch, card)
    log(f"LM families phase 3e: {time.time() - t0:.1f} s wall")
    return lines


# ---------------------------------------------------------------------------
# Phase 3f: the MoE, Mamba, hybrid and stub-frontend archs trained
# ---------------------------------------------------------------------------


def _family_cfg(configs, arch: str, depth, dtype: str = "bfloat16"):
    """``arch`` at its published width, ``depth`` layers (None: all;
    "group": one layer group), or its smoke config's widths and depth
    ("smoke") with the published config's chunks (``ssm_chunk``,
    ``moe_chunk``: the smoke config's Mamba chunk of 8 would cut a
    2048-token row into 256 chunks of launches), in ``dtype``."""
    cfg = configs.get_config(arch)
    if depth == "smoke":
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  ssm_chunk=cfg.ssm_chunk,
                                  moe_chunk=cfg.moe_chunk)
    else:
        layers = {None: cfg.n_layers, "group": cfg.period}.get(depth, depth)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype)


def family_training_path(torch, mods, counters, card: str) -> dict:
    """Slices 13 and 14's path (phase 3f): the nine archs of phase 3e
    trained on the card, one arch's state freed before the next."""
    configs = mods["configs"]
    t0 = time.time()
    lines = {}
    for arch, depth, b in FAMILY_TRAIN:
        t1 = time.time()
        lines[arch] = train_full(
            torch, mods, counters, card, _family_cfg(configs, arch, depth),
            b, TRAIN["seq"], "train 3f (a)", lr=FAMILY_LR.get(arch, TRAIN_LR),
            prefill_len=TRAIN["seq"] if arch in FAMILY_SERVE else 0)
        log(f"train 3f (a) {arch}: {time.time() - t1:.1f} s")
    t1 = time.time()
    group = {arch: "smoke" if depth == "smoke" else "group"
             for arch, depth, _b in FAMILY_TRAIN}
    for arch in group:
        train_bits(torch, mods, counters,
                   _family_cfg(configs, arch, group[arch]), "train 3f (b)")
    train_bits(torch, mods, counters,
               _family_cfg(configs, TRAIN["arch"], TRAIN_CUT_LAYERS),
               "train 3f (b)")
    log(f"train 3f (b): {time.time() - t1:.1f} s")
    t1 = time.time()
    for arch in group:
        train_grad_check(torch, mods, counters,
                         _family_cfg(configs, arch, group[arch], "float32"),
                         f"train 3f (c) {arch}")
    log(f"train 3f (c): {time.time() - t1:.1f} s")
    for arch in FAMILY_LIFECYCLE:
        t1 = time.time()
        train_lifecycle(torch, mods, counters, card,
                        dict(FAMILY_LIFECYCLE_JOB, arch=arch,
                             lr=FAMILY_LR.get(arch, TRAIN_LR)),
                        TRAIN["steps"], f"train 3f (d) {arch}")
        train_restore_mixed(torch, mods, arch, f"train 3f (d) {arch}")
        log(f"train 3f (d) {arch}: {time.time() - t1:.1f} s")
    log(f"train families phase 3f: {time.time() - t0:.1f} s wall")
    return lines


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile_window(torch, label, fn, top: int = 6) -> dict:
    """Run ``fn`` under ``torch.profiler``; print the device's busy share of
    the window's wall time and the kernels that took the most device time,
    and return the wall, the busy time and each kernel's time (ms).  Only
    the device is traced (kernels, copies, memsets): every number here is
    the device's, and the host side of a window's trace took the profiler
    up to 43 s to read back (falcon-mamba's prefill, 49,791 device ops;
    PERF.md)."""
    prof_mod = torch.profiler
    acts = [prof_mod.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t_read = time.time()
    with prof_mod.profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    device = torch.autograd.DeviceType.CUDA
    evts = [e for e in prof.key_averages()
            if e.device_type == device and _device_us(e) > 0]
    read_s = time.time() - t_read - wall_us / 1e6
    busy = sum(_device_us(e) for e in evts)
    ranked = sorted(evts, key=_device_us, reverse=True)[:top]
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms (profiler on), "
        f"device busy {busy / 1e3:.3f} ms = {busy / wall_us:.3f} of the "
        f"wall, {sum(e.count for e in evts)} device ops, the profiler's own "
        f"set-up and read-back {read_s:.1f} s; top: " + "; ".join(
            f"{e.key[:60]} x{e.count} {_device_us(e) / 1e3:.3f} ms"
            for e in ranked))
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                by_kernel={e.key: (e.count, _device_us(e) / 1e3)
                           for e in evts})


def profile_serving(torch, mods, cfg) -> None:
    """Where the serving path's time goes: prefill and 8 decode steps at
    the timed run's shape, each under the profiler."""
    lm = mods["lm"]
    g = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(g, cfg, device=DEV)
    b, p, n = SERVE["batch"], SERVE["prompt_len"], 8
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=g, device=DEV)
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill_step(
            params, prompts, cfg, max_seq=p + n)

    def decode():
        logits, cache = state["logits"], state["cache"]
        for i in range(n):
            tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            logits, cache = lm.decode_step(params, cache, tok, p + i, cfg)

    # the profiler's first window pays its own set-up (seconds): spend it
    # on a trivial one
    profile_window(torch, "warm-up", lambda: torch.ones(8, device=DEV) + 1)
    profile_window(torch, f"prefill (batch {b}, prompt {p})", prefill)
    profile_window(torch, f"decode ({n} steps, batch {b})", decode)


# ---------------------------------------------------------------------------
# Phase 6: the pod-scale K-Means cell on one card, the GPipe pipeline, and
# the dry-run held to the card
# ---------------------------------------------------------------------------


def _event_ms(torch, fn) -> tuple:
    """(device ms of one call of ``fn`` by CUDA events, its result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def start_dryruns(mods) -> tuple:
    """Phase 6 (c)'s five dry-run cells, each a ``launch.dryrun`` process
    of its own on the host (the meta device), started now so that they run
    beside (a) and (b): (their output directory, the processes)."""
    out = tempfile.mkdtemp(prefix="dryrun_", dir=mods["tmp"])
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch, shape in DRYRUN_CELLS]
    return out, procs


def pod_kmeans(torch, mods, counters, card: str) -> tuple:
    """(a) The reference's pod-scale cell, one K-Means step at n = 2^24,
    d = 128, k = 4,096, through ``clustering_step_for_dryrun`` on meshes of
    2 and 16 shards of the card, held to the plain step; and the kernels
    line's row of pass 1 at a 2-shard shard.  Returns (launches, row)."""
    dist, kmeans, synth, fops, dref, dops = (
        mods["dist"], mods["kmeans"], mods["synth"], mods["fops"],
        mods["dref"], mods["dops"])
    n, d, k = POD["n"], POD["d"], POD["k"]
    torch.cuda.empty_cache()
    t0 = time.time()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x, _, _ = synth.make_blobs(gen, synth.ClusterSpec(d, k, n // k),
                               device=DEV)
    c = x[torch.randperm(n, generator=gen, device=DEV)[:k]].contiguous()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"pod (a): {n} x {d} points of {k} blobs and {k} of them as "
        f"centroids drawn on the card in {time.time() - t0:.2f} s")

    # the main path: the step on 2 shards, then on 16 (the pod's data axis)
    torch.cuda.reset_peak_memory_stats()
    cfg = kmeans.KMeansConfig(k=k)
    results, walls = {}, {}
    reset(counters)
    for p in POD_SHARDS:
        step = dist.clustering_step_for_dryrun(
            cfg, dist.Mesh((torch.device(DEV),) * p))
        walls[p] = timed_wall(torch, lambda: results.__setitem__(p, step(x, c)))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    shards = sum(1 for p in POD_SHARDS
                 for a, b in dist.kmeans_bounds(n, k, d, p) if b > a)
    check(launches["fused_masked_assign_update"] == shards
          and launches["reduce_partials"] == len(POD_SHARDS),
          f"pod (a): launches {launches}, not {shards} pass-1 and "
          f"{len(POD_SHARDS)} pass-2 launches")
    a2, c2, shift2, inert2 = results[2]
    check(all(bool(torch.equal(u, v)) for u, v in zip(results[2],
                                                      results[16])),
          "pod (a): the steps on 2 and 16 shards differ")
    log(f"pod (a): step on 2 shards {walls[2]!r} s, on 16 shards "
        f"{walls[16]!r} s (host wall to a synchronise; a mesh repeating "
        f"the card runs its shards on side streams; the first wide form, "
        f"on an H100 at 700 W: 6.730 / 8.199 s), launches {launches}, "
        f"results bitwise equal, peak {peak / 1e9!r} GB; card {card}")

    # row 2p: pass 1 over each 2-shard shard alone and pass 2, by events
    rows = fops.block_rows(n, k, d)
    mask = torch.ones(n, dtype=torch.bool, device=DEV)
    bounds = dist.kmeans_bounds(n, k, d, 2)
    parts, pass1 = [], []
    for a, b in bounds:
        ms, out = _event_ms(torch, lambda: fops.fused_masked_partials(
            x[a:b], c, mask[a:b], rows))
        pass1.append(ms)
        parts.append(out)
    rechecks = recheck_line(dops, fops.fused_masked_assign_update,
                            f"pod pass 1 over {bounds[-1][1] - bounds[-1][0]}"
                            f" rows", bounds[-1][1] - bounds[-1][0])
    part = torch.cat([pt for _, pt in parts])
    pass2 = time_ms(torch, lambda: fops.reduce_partials(part, k, d), reps=5)
    sums, counts, inertia = fops.reduce_partials(part, k, d)
    c_new, _ = kmeans.update_from_partials(c, sums, counts)
    check(bool(torch.equal(torch.cat([i for i, _ in parts]), a2))
          and bool(torch.equal(c_new, c2)) and bool(torch.equal(inertia,
                                                                inert2)),
          "pod (a): the passes alone differ from the step's")
    log(f"pod (a): pass 1 {pass1!r} ms a launch ({[b - a for a, b in bounds]}"
        f" rows, {[-(-(b - a) // rows) for a, b in bounds]} blocks of "
        f"{rows} rows), pass 2 {pass2!r} ms over {part.shape[0]} partials; "
        f"card {card}")

    # the plain step: the use_kernel=False branch on 16 shards
    reset(counters)
    plain = dist.clustering_step_for_dryrun(
        kmeans.KMeansConfig(k=k, use_kernel=False),
        dist.Mesh((torch.device(DEV),) * 16))
    wall_plain = timed_wall(torch, lambda: results.__setitem__("plain",
                                                               plain(x, c)))
    _check_no_launch(counters, "pod (a) plain step")
    pa, pc, pshift, pinert = results.pop("plain")
    check(bool(torch.equal(a2, pa)),
          f"pod (a): {int((a2 != pa).sum())} assignments differ from the "
          f"plain step")
    pcounts = torch.bincount(pa.long(), minlength=k).float()
    check(bool(torch.equal(counts, pcounts)),
          "pod (a): counts differ from the plain step's")
    xmax = float(x.abs().max())
    dc = float((c2 - pc).abs().max())
    check(dc <= POD_TOL * xmax, f"pod (a): new centroids differ by {dc} "
                                f"(largest |x| {xmax})")
    for what, u, v in (("shift", shift2, pshift), ("inertia", inert2,
                                                    pinert)):
        rel = abs(float(u) - float(v)) / abs(float(v))
        check(rel <= POD_TOL, f"pod (a): {what} {float(u)} vs plain "
                              f"{float(v)} (rel {rel})")
    log(f"pod (a): the plain step on 16 shards {wall_plain!r} s: "
        f"assignments equal, counts exact, new centroids within {dc!r} "
        f"(largest |x| {xmax!r}), shift {float(shift2)!r} vs "
        f"{float(pshift)!r}, inertia {float(inert2)!r} vs {float(pinert)!r}")
    del pa, pc, results
    torch.cuda.empty_cache()

    # the row's plain version and library call on the first 2-shard shard
    a0, b0 = bounds[0]
    n0 = b0 - a0
    plain_ms, (ridx, rpart) = _event_ms(torch, lambda: (
        dref.fused_masked_partials_ref(x[a0:b0], c, mask[a0:b0], rows)))
    idx0, part0 = parts[0]
    stride = k * d + k + 1
    cnt, rcnt = part0[:, k * d:k * d + k], rpart[:, k * d:k * d + k]
    dsums = (part0[:, :k * d] - rpart[:, :k * d]).abs().view(-1, k, d)
    err = float(dsums.max())
    check(bool(torch.equal(idx0, ridx)) and bool(torch.equal(cnt, rcnt))
          and bool((dsums <= POD_TOL * rcnt[:, :, None] * xmax
                    + 1e-6).all())
          and bool(torch.allclose(part0[:, -1], rpart[:, -1], rtol=POD_TOL,
                                  atol=0.0)),
          f"pod (a): pass 1 over a 2-shard shard differs from the plain "
          f"version (max |dsums| {err})")
    del ridx, rpart, dsums

    def composed():
        # a yardstick of stock PyTorch calls, never called by the port
        sums = torch.zeros((k, d), device=DEV)
        cnts = torch.zeros(k, device=DEV)
        cols = torch.arange(k, device=DEV)
        for r in range(a0, b0, 1 << 18):
            xc = x[r:min(b0, r + (1 << 18))]
            oh = (torch.cdist(xc, c).argmin(1)[:, None] == cols).float()
            sums += oh.T @ xc
            cnts += oh.sum(0)
        return sums, cnts

    lib_ms, _ = _event_ms(torch, composed)
    blocks0 = -(-n0 // rows)
    moved = n0 * d * 4 + n0 + 4 * n0 + 4 * blocks0 * stride + 4 * k * d
    b, by = bound(moved, 3 * 2.0 * n0 * k * d, PEAK_TF32)
    search = search_line(dops, n0, k, d, x.device)
    log(f"pod (a) row 2p: pass 1 over {n0} rows ({blocks0} blocks of "
        f"sums; the search {search}) {pass1[0]!r} ms (the first wide form, "
        f"on an H100 at 700 W: 6497.9), bound {b!r} ms ({by}), plain "
        f"{plain_ms!r} ms, "
        f"library (cdist + one-hot, chunked) {lib_ms!r} ms; indices and "
        f"counts equal to the plain version, max |dsums| {err!r}")

    # the dry-run's inventory of the same step on a one-device mesh
    rec = mods["dryrun_cluster"].kmeans_cell(
        mods["AbstractMesh"](("data",), (1,)))
    log(f"pod (a): dry-run on a one-device mesh: FLOPs "
        f"{rec['cost_analysis']['flops']!r}, argument bytes "
        f"{rec['memory_analysis']['argument_size_in_bytes']}, temps "
        f"{rec['memory_analysis']['temp_size_in_bytes']}; the card's "
        f"max_memory_allocated over the two steps {peak}; card {card}")
    del x, c, mask, part, parts
    torch.cuda.empty_cache()
    row = dict(name="fused_masked_partials_pod", route="cuda",
               source="src/repro_torch/csrc/fused.cu",
               replaces="src/repro/kernels/distance/fused.py:42",
               max_abs_err=err, ms=pass1[0], plain_ms=plain_ms, bound_ms=b,
               bound_by=by, library_ms=lib_ms,
               library_call="cdist(x, c).argmin(1) + one-hot matmul "
                            "(composed, chunked)",
               shape=f"pass 1 over a 2-shard shard: n={n0} of {n} d={d} "
                     f"k={k}, {blocks0} blocks",
               launch_shape=list(fops.launch_shape(n, k, d)),
               search=search, rechecks=rechecks,
               device_ms=dict(pass1=pass1, pass2=pass2))
    return launches, row


def pipeline_path(torch, mods, counters, card: str) -> None:
    """(b) GPipe on the card: OLMo-1B's 16 layers in 4 stages on a mesh
    repeating the card, bf16, no_grad, against ``hidden_forward`` per
    microbatch; then 4 one-layer stages in fp32 under autograd."""
    configs, lm, pipe, dist, tstep = (mods["configs"], mods["lm"],
                                      mods["pipeline"], mods["dist"],
                                      mods["tstep"])
    cfg = configs.get_config(PIPE["arch"])
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(gen, cfg, device=DEV)
    m, mb, s = PIPE["microbatches"], PIPE["batch"], PIPE["seq"]
    tokens = torch.randint(0, cfg.vocab, (m, mb, s), generator=gen,
                           device=DEV)
    mesh = dist.Mesh((torch.device(DEV),) * PIPE["stages"], axis="pipe")
    with torch.no_grad():
        lm.hidden_forward(params, tokens[0], cfg)     # warm-up, untimed
        reset(counters)
        out = []
        wall = timed_wall(torch, lambda: out.append(
            pipe.pipelined_hidden_forward(mesh, params, tokens, cfg)))
        by_route = dict(counters["flash_attention"].launches_by_route)
        check(by_route == {"tc": cfg.n_layers * m, "simt": 0},
              f"pipe (b): flash launches {by_route}, not "
              f"{cfg.n_layers * m} on \"tc\"")
        ref = []
        wall_ref = timed_wall(torch, lambda: ref.extend(
            lm.hidden_forward(params, tokens[i], cfg)[0] for i in range(m)))
        check(all(bool(torch.equal(out[0][i], ref[i])) for i in range(m)),
              "pipe (b): pipelined hidden states differ from hidden_forward")
    log(f"pipe (b): {cfg.name} {cfg.n_layers} layers in {mesh.size} stages "
        f"on the card, bf16, {m} microbatches of {mb} x {s}: pipelined "
        f"{wall!r} s, per microbatch {wall_ref!r} s, hidden states bitwise "
        f"equal, flash launches {by_route}; card {card}")
    del params, out, ref
    torch.cuda.empty_cache()

    gcfg = dataclasses.replace(cfg, n_layers=PIPE_GRAD["layers"],
                               dtype="float32")
    params = tstep.as_trainable(lm.init_params(gen, gcfg, device=DEV))
    toks = torch.randint(0, gcfg.vocab, (m, PIPE_GRAD["batch"],
                                         PIPE_GRAD["seq"]), generator=gen,
                         device=DEV)
    leaves = mods["tree_leaves"](params)
    grads = {}

    def run(name, hidden):
        loss = torch.mean(hidden() ** 2)
        grads[name] = torch.autograd.grad(loss, leaves)

    run("warm-up", lambda: lm.hidden_forward(params, toks[0], gcfg)[0])
    wall_g = timed_wall(torch, lambda: run("pipe", lambda: (
        pipe.pipelined_hidden_forward(mesh, params, toks, gcfg))))
    wall_gr = timed_wall(torch, lambda: run("ref", lambda: torch.stack([
        lm.hidden_forward(params, toks[i], gcfg)[0] for i in range(m)])))
    worst = 0.0
    for g, gr in zip(grads["pipe"], grads["ref"]):
        top = float(gr.abs().max())
        worst = max(worst, float((g - gr).abs().max()) / top)
    check(worst <= PIPE_GRAD_TOL,
          f"pipe (b): fp32 gradients differ by {worst} of the largest |g|")
    log(f"pipe (b): {gcfg.n_layers} one-layer stages at {cfg.name} width, "
        f"fp32, {m} x ({PIPE_GRAD['batch']} x {PIPE_GRAD['seq']}) under "
        f"autograd: pipelined {wall_g!r} s, unpipelined {wall_gr!r} s, "
        f"every gradient leaf within {worst!r} of its largest |g|")
    del params, grads
    torch.cuda.empty_cache()


def dryrun_checks(torch, mods, train: dict, out_dir: str, procs,
                  card: str) -> None:
    """(c) The dry-run of phase 3d's OLMo-1B train cell on a one-device
    mesh held to what 3d measured; then the five cells' records."""
    cells, dryrun = mods["cells"], mods["dryrun"]
    shape = mods["configs"].ShapeSpec("train_3d", TRAIN["seq"],
                                      TRAIN["batch"], "train")
    cell = cells.build_cell(TRAIN["arch"], shape,
                            mods["AbstractMesh"](("data",), (1,)))
    tr = cells.trace_cell(cell)
    state = cells.tree_bytes(cell.args[:1], cell.specs[:1], cell.mesh)
    full = train["full"]
    st = cell.args[0]
    sizes = [t.numel() * t.itemsize for t in mods["tree_leaves"](st.params)
             + mods["tree_leaves"](st.opt) + [st.step]]
    check(len(sizes) == full["state_tensors"],
          f"dryrun (c): {len(sizes)} state tensors traced, "
          f"{full['state_tensors']} on the card")
    # the caching allocator rounds a block of up to 1 MiB to 512 bytes, and
    # hands a larger one out whole when less than 1 MiB would remain
    slack = sum(ALLOC_SMALL_ROUND if n <= ALLOC_SPLIT else ALLOC_SPLIT
                for n in sizes)
    check(0 <= full["state_alloc"] - state <= slack,
          f"dryrun (c): the state's argument bytes {state} vs "
          f"{full['state_alloc']} allocated on the card (rounding {slack})")
    mem = (cells.argument_bytes(cell) + tr["temp_size_in_bytes"]) \
        / full["peak"]
    check(1 / DRYRUN_RATIO_LIMIT <= mem <= DRYRUN_RATIO_LIMIT,
          f"dryrun (c): argument + temp bytes {mem} x phase 3d's peak")
    log(f"dryrun (c): {TRAIN['arch']} train at {TRAIN['batch']} x "
        f"{TRAIN['seq']}, full depth, one-device mesh (trace "
        f"{tr['seconds']!r} s): state {state} B vs {full['state_alloc']} B "
        f"allocated by phase 3d ({full['state_tensors']} tensors, the "
        f"allocator's rounding at most {slack} B); "
        f"argument + temp {cells.argument_bytes(cell)} + "
        f"{tr['temp_size_in_bytes']} B = {mem!r} x 3d's peak "
        f"{full['peak']} B; FLOPs {tr['flops']!r} = "
        f"{tr['flops'] / full['flops']!r} x the smoke's train_flops "
        f"{full['flops']!r}; card {card}")
    for proc, (arch, shape_name) in zip(procs, DRYRUN_CELLS):
        text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        check(proc.returncode == 0, f"dryrun (c): {arch} x {shape_name} "
                                    f"exited {proc.returncode}: {text[-2000:]}")
        path = Path(out_dir) / dryrun.mesh_name(False) / \
            f"{arch}__{shape_name}.json"
        rec = json.loads(path.read_text())
        ma = rec["memory_analysis"]
        log(f"dryrun (c): {arch} {shape_name} on the single pod: argument "
            f"{ma['argument_size_in_bytes'] / 1e9!r} GB a device, temp "
            f"{ma['temp_size_in_bytes'] / 1e9!r} GB"
            f"{' (upper bound)' if ma['temp_is_upper_bound'] else ''}, "
            f"FLOPs {rec['cost_analysis']['flops']!r} (local batch "
            f"{rec['local_batch']}), modelled wire "
            f"{rec['collectives']['total_wire_bytes']!r} B, trace "
            f"{rec['seconds_trace']!r} s")


def pod_path(torch, mods, counters, card: str, train: dict) -> tuple:
    """Phase 6: (c)'s dry-runs start on the host, (a) and (b) run on the
    card meanwhile, then (c) reads them.  Every process it starts is
    stopped before it returns."""
    t0 = time.time()
    out_dir, procs = start_dryruns(mods)
    try:
        launches, row = pod_kmeans(torch, mods, counters, card)
        log(f"phase 6 (a): {time.time() - t0:.1f} s")
        t1 = time.time()
        pipeline_path(torch, mods, counters, card)
        log(f"phase 6 (b): {time.time() - t1:.1f} s")
        t1 = time.time()
        dryrun_checks(torch, mods, train, out_dir, procs, card)
        log(f"phase 6 (c): {time.time() - t1:.1f} s after (b)")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    log(f"phase 6: {time.time() - t0:.1f} s")
    return launches, row


def workdir(mods, prefix: str) -> str:
    """A new directory under the run's scratch root, removed at exit."""
    return tempfile.mkdtemp(prefix=prefix, dir=mods["tmp"])


def reset(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        by_route = getattr(fn, "launches_by_route", None)
        if by_route is not None:
            for route in by_route:
                by_route[route] = 0


def main_path(torch, mods, counters) -> dict:
    mine, kmeans, dbscan, synth = (mods["mine"], mods["kmeans"],
                                   mods["dbscan"], mods["synth"])
    launches = {}
    work = workdir(mods, "mine_")

    # --- K-Means at full width -------------------------------------------
    reset(counters)
    km = mine.run_mining_job(algo="kmeans", workdir=work, device=DEV,
                             seed=SEED, **ASSIGN_SHAPE)
    launches["assign_clusters"] = counters["assign_clusters"].launches
    check(km["final_state"] == "SUCCEEDED", f"kmeans job: {km['final_state']}")
    check(launches["assign_clusters"] >= km["iterations"] >= 1,
          f"kmeans: {launches['assign_clusters']} assignment launches for "
          f"{km['iterations']} iterations")
    check(counters["epsilon_degree"].launches == 0
          and counters["expand_frontier"].launches == 0,
          "kmeans job launched DBSCAN kernels")
    log(f"kmeans: n={ASSIGN_SHAPE['clusters'] * ASSIGN_SHAPE['size']} "
        f"wall {km['wall_s']:.3f} s, {km['iterations']} iterations, "
        f"converged={km['converged']}, inertia {km['inertia']!r}, "
        f"assign launches {launches['assign_clusters']}")
    reset(counters)
    km_plain = mine.run_mining_job(algo="kmeans", workdir=work, device=DEV,
                                   seed=SEED, use_kernel=False, **ASSIGN_SHAPE)
    check(counters["assign_clusters"].launches == 0,
          "plain kmeans job launched the kernel")
    rel = abs(km["inertia"] - km_plain["inertia"]) / abs(km_plain["inertia"])
    check(rel <= 1e-4, f"kmeans inertia {km['inertia']} vs plain "
                       f"{km_plain['inertia']} (rel {rel})")
    log(f"kmeans plain: wall {km_plain['wall_s']:.3f} s, "
        f"{km_plain['iterations']} iterations, inertia rel diff {rel!r}")
    x, _, _ = synth.make_blobs(SEED, spec_of(synth, ASSIGN_SHAPE),
                               device=DEV)
    cfg = kmeans.KMeansConfig(k=ASSIGN_SHAPE["clusters"])
    c0 = kmeans.init_centroids(SEED, x, cfg)
    a_k = kmeans.kmeans_step(x, c0, cfg)[0]
    a_p = kmeans.kmeans_step(
        x, c0, kmeans.KMeansConfig(k=cfg.k, use_kernel=False))[0]
    check(bool((a_k == a_p).all()), "kmeans step-1 assignment differs "
                                    "from the plain run")
    check(km["labels"].shape == (x.shape[0],), "kmeans labels shape")
    wall = timed_wall(torch, lambda: kmeans.fit(SEED, x, cfg))
    log(f"kmeans core fit (no job store): wall {wall:.3f} s")

    # --- DBSCAN at full width --------------------------------------------
    reset(counters)
    db = mine.run_mining_job(algo="dbscan", workdir=work, device=DEV,
                             seed=SEED, **DBSCAN_SHAPE)
    launches["epsilon_degree"] = counters["epsilon_degree"].launches
    launches["expand_frontier"] = counters["expand_frontier"].launches
    check(db["final_state"] == "SUCCEEDED", f"dbscan job: {db['final_state']}")
    check(launches["epsilon_degree"] == 1,
          f"dbscan: {launches['epsilon_degree']} degree launches")
    check(launches["expand_frontier"] == db["expansions"] >= 1,
          f"dbscan: {launches['expand_frontier']} expansion launches for "
          f"{db['expansions']} expansions")
    check(counters["assign_clusters"].launches == 0,
          "dbscan job launched the assignment kernel")
    log(f"dbscan: n={DBSCAN_SHAPE['clusters'] * DBSCAN_SHAPE['size']} "
        f"wall {db['wall_s']:.3f} s, {db['expansions']} expansions, "
        f"{db['n_clusters']} clusters, {db['noise']} noise points")
    reset(counters)
    db_plain = mine.run_mining_job(algo="dbscan", workdir=work, device=DEV,
                                   seed=SEED, use_kernel=False, **DBSCAN_SHAPE)
    check(counters["epsilon_degree"].launches == 0
          and counters["expand_frontier"].launches == 0,
          "plain dbscan job launched a kernel")
    check(bool(torch.equal(db["labels"], db_plain["labels"])),
          "dbscan labels differ from the plain run")
    log(f"dbscan plain: wall {db_plain['wall_s']:.3f} s, labels equal")
    x, _, _ = synth.make_blobs(SEED, spec_of(synth, DBSCAN_SHAPE),
                               device=DEV)
    dcfg = dbscan.DBSCANConfig.paper_defaults(DBSCAN_SHAPE["features"])
    wall = timed_wall(torch, lambda: dbscan.fit(x, dcfg))
    log(f"dbscan core fit (no job store): wall {wall:.3f} s")
    return launches


def _svc_workload(serve_mine, algo, shape, seed, requests=SVC_REQUESTS):
    return serve_mine.build_workload(
        requests, 4, algo, features=shape["features"],
        clusters=shape["clusters"], points=shape["points"],
        min_points=shape["min_points"], seed=seed)


def _svc(mods, work, **kw):
    return mods["service"].ClusteringService(
        work, device=DEV, max_batch=SVC_MAX_BATCH, continuous=True,
        bucket_policy="pow2", **kw)


def _drive(mods, svc, workload, executor) -> tuple:
    serve_mine = mods["serve_mine"]
    client = serve_mine.MiningClient(service=svc)
    results: list = []
    t0 = time.time()
    failures = serve_mine.drive(client, workload, rate=0, executor=executor,
                                timeout=900, results=results)
    wall = time.time() - t0
    check(failures == {"suspended": 0, "dropped": 0, "rejected": 0},
          f"service on {executor}: failures {failures}")
    check(all(r is not None and r["executor"] == executor for r in results),
          f"service: a request did not resolve on {executor}")
    return results, wall


def _report_service(label, svc, wall, results) -> dict:
    snap = svc.metrics_snapshot()
    lanes = snap["by_executor"]
    log(f"service {label}: {len(results)} requests in {wall:.3f} s wall, "
        f"p50 {snap['p50_latency_s'] * 1e3:.1f} ms / p99 "
        f"{snap['p99_latency_s'] * 1e3:.1f} ms, batches {snap['batches']}, "
        f"joins {snap['continuous']['joins']}, "
        f"lanes " + json.dumps({
            n: {k: st[k] for k in ("batches", "requests", "exec_s", "host_s",
                                   "device_s")} for n, st in lanes.items()}))
    return snap


def profile_lane_batch(torch, mods, warm) -> None:
    """Where one K-Means batch of the kernel lane spends its time: a batch
    of new requests on a service of its own (warmed as the main one), under
    the profiler; its device time split into the fused step's kernels and
    the rest, beside the lane's exec_s - host_s for the batch (a residual
    on the host clock)."""
    work = _svc_workload(mods["serve_mine"], "kmeans", SVC_KMEANS, SEED + 7,
                         requests=SVC_MAX_BATCH)
    svc = _svc(mods, workdir(mods, "prof_"), warm_start=warm)
    svc.start()
    try:
        profile_window(torch, "warm-up",
                       lambda: torch.ones(8, device=DEV) + 1)
        prof = profile_window(
            torch, f"service K-Means batch ({len(work)} requests, "
                   f"cuda-kernel)",
            lambda: _drive(mods, svc, work, "cuda-kernel"))
    finally:
        svc.stop()   # joins the lane: the batch is recorded after this
    lane = svc.metrics_snapshot()["by_executor"]["cuda-kernel"]
    fused = [(key, cnt, ms) for key, (cnt, ms) in prof["by_kernel"].items()
             if any(name in key for name in ("fused_partials_kernel",
                                             "reduce_partials_kernel",
                                             "pack_centroids"))]
    fused_ms = sum(ms for _k, _c, ms in fused)
    resid = lane["exec_s"] - lane["host_s"]
    log(f"service K-Means batch profile: device busy {prof['busy_ms']:.3f} "
        f"ms of {prof['wall_ms']:.3f} ms wall; the fused step's kernels "
        f"{fused_ms:.3f} ms (" + "; ".join(
            f"{key[:40]} x{cnt} {ms:.3f} ms" for key, cnt, ms in fused)
        + f"), other device work {prof['busy_ms'] - fused_ms:.3f} ms; the "
        f"lane's exec_s - host_s {resid:.3f} s (exec_s {lane['exec_s']:.3f}"
        f" s, host_s {lane['host_s']:.3f} s, {lane['batches']} batch(es))")


def service_path(torch, mods, counters) -> dict:
    """Slice 2's main path: the service's kernel lane at full width."""
    serve_mine, kmeans, dbscan = (mods["serve_mine"], mods["kmeans"],
                                  mods["dbscan"])
    cuda, ref = "cuda-kernel", "torch-ref"
    t0 = time.time()
    km_work = _svc_workload(serve_mine, "kmeans", SVC_KMEANS, SEED)
    db_work = _svc_workload(serve_mine, "dbscan", SVC_DBSCAN, SEED + 1)
    log(f"service workload built in {time.time() - t0:.2f} s: K-Means sizes "
        f"{[w[2].shape[0] for w in km_work]}, DBSCAN sizes "
        f"{[w[2].shape[0] for w in db_work]}")
    d = SVC_KMEANS["features"]
    n_max = max(w[2].shape[0] for w in km_work)
    warm = [{"algo": "kmeans", "features": d, "n": n_max,
             "k": SVC_KMEANS["clusters"], "max_iters": 50,
             "executor": cuda}]
    svc = _svc(mods, workdir(mods, "svc_"),
               warm_start=warm)
    t0 = time.time()
    svc.start()
    log(f"service start (warm-up of the K-Means bucket): "
        f"{time.time() - t0:.3f} s, exec cache {svc.exec_cache.stats()}")
    launches = {}
    try:
        cache0 = svc.exec_cache.stats()
        reset(counters)
        km_res, km_wall = _drive(mods, svc, km_work, cuda)
        db_res, db_wall = _drive(mods, svc, db_work, cuda)
        for name in ("fused_masked_assign_update", "epsilon_degree",
                     "expand_frontier", "assign_clusters"):
            launches[name] = counters[name].launches
        cache1 = svc.exec_cache.stats()
    finally:
        svc.stop()   # joins the lanes: every batch is recorded after this
    snap = _report_service("kernel lane", svc, km_wall + db_wall,
                           km_res + db_res)
    iters = [r["iterations"] for r in km_res]
    check(set(snap["by_executor"]) == {cuda},
          f"service batches ran on {sorted(snap['by_executor'])}")
    check(launches["fused_masked_assign_update"] >= sum(iters) >= 1,
          f"service: {launches['fused_masked_assign_update']} fused launches "
          f"for {sum(iters)} K-Means iterations")
    check(launches["epsilon_degree"] == len(db_work),
          f"service: {launches['epsilon_degree']} degree launches for "
          f"{len(db_work)} DBSCAN items")
    check(launches["expand_frontier"] >= 1, "service: no expansion launch")
    check(launches["assign_clusters"] == 0,
          "service: the kernel lane launched the unfused assignment")
    check(cache1["warmed"] >= 1 and cache1["misses"] == cache0["misses"],
          f"exec cache: warmed {cache1['warmed']}, misses "
          f"{cache0['misses']} -> {cache1['misses']}")
    log(f"service launches {launches}; K-Means iterations {iters}; "
        f"exec cache {cache1}; K-Means wall {km_wall:.3f} s, "
        f"DBSCAN wall {db_wall:.3f} s")

    # DBSCAN: the plain run on the card, request by request
    for (_t, _a, x, params), r in zip(db_work, db_res):
        cfg = dbscan.DBSCANConfig(eps=params["eps"], min_pts=params["min_pts"],
                                  use_kernel=False)
        plain = dbscan.fit(torch.from_numpy(x).to(DEV), cfg)
        check(bool((plain.labels.cpu().numpy() == r["labels"]).all()),
              "service DBSCAN labels differ from the plain run on the card")
    log(f"service DBSCAN: labels of all {len(db_res)} requests equal the "
        f"plain run; clusters {[r['n_clusters'] for r in db_res]}")

    # K-Means: the same requests pinned to the plain lane
    svc_ref = _svc(mods, workdir(mods, "ref_"))
    svc_ref.start()
    try:
        ref_res, ref_wall = _drive(mods, svc_ref, km_work, ref)
    finally:
        svc_ref.stop()
    _report_service("torch-ref lane", svc_ref, ref_wall, ref_res)
    rels = []
    for r, p in zip(km_res, ref_res):
        rel = abs(r["inertia"] - p["inertia"]) / abs(p["inertia"])
        rels.append(rel)
        check(rel <= 1e-4,
              f"service K-Means: {r['iterations']} iterations inertia "
              f"{r['inertia']} vs torch-ref {p['iterations']} / "
              f"{p['inertia']} (rel {rel})")
    log(f"service K-Means vs torch-ref: inertia rel diff max {max(rels)!r}"
        f", iterations {iters} vs {[p['iterations'] for p in ref_res]}")

    # both lanes' cached steps from the same centroids on one padded item
    _t, _a, x, params = km_work[0]
    n_pad = 1 << (n_max - 1).bit_length()
    xp = torch.zeros((n_pad, d), device=DEV)
    xp[: x.shape[0]] = torch.from_numpy(x).to(DEV)
    mask = torch.arange(n_pad, device=DEV) < x.shape[0]
    cfg_k = kmeans.KMeansConfig(k=params["k"], max_iters=50)
    cfg_p = kmeans.KMeansConfig(k=params["k"], max_iters=50, use_kernel=False)
    c0 = kmeans.init_centroids(params["seed"], xp[: x.shape[0]], cfg_k)
    a_k = svc.exec_cache.kmeans_step(n_pad, d, cfg_k, DEV)(xp, c0, mask)[0]
    a_p = svc.exec_cache.kmeans_step(n_pad, d, cfg_p, DEV)(xp, c0, mask)[0]
    check(bool(torch.equal(a_k, a_p)),
          "service: cuda-kernel and torch-ref step-1 assignments differ")
    log(f"service step 1 on a padded item (n={x.shape[0]} of {n_pad}): "
        f"cuda-kernel and torch-ref assignments equal")
    # the Lloyd loop's iteration as the lane runs it: step + the shift read
    # that decides the stop rule (one host sync per iteration)
    step = svc.exec_cache.kmeans_step(n_pad, d, cfg_k, DEV)
    c, reps = c0, 20

    def loop():
        nonlocal c
        for _ in range(reps):
            _a, c, shift, _i = step(xp, c, mask)
            float(shift)

    per_iter = timed_wall(torch, loop) / reps * 1e3
    kernel = time_ms(
        torch, lambda: mods["fops"].fused_masked_assign_update(xp, c0, mask),
        reps=reps)
    log(f"service Lloyd iteration on the card: {per_iter:.3f} ms per "
        f"iteration (host clock, step + shift sync) against the fused "
        f"kernel's {kernel:.3f} ms (CUDA events)")
    profile_lane_batch(torch, mods, warm)
    return launches


def service_preemption(mods) -> None:
    """4b: a service batch cancelled mid-run on the card resumes in a fresh
    service over the same workdir to the uninterrupted labels."""
    serve_mine, service = mods["serve_mine"], mods["service"]
    shape = PREEMPT_KMEANS
    work = serve_mine.build_workload(
        2, 2, "kmeans", features=shape["features"],
        clusters=shape["clusters"], points=shape["points"], seed=SEED + 3)
    for w in work:
        w[3]["max_iters"] = PREEMPT_ITERS
        w[3]["tol"] = 0.0   # never converges: runs every iteration
    # both requests form one batch: max_batch is reached before max_wait
    kw = dict(device=DEV, max_batch=2, max_wait_s=10.0, continuous=True,
              bucket_policy="pow2", checkpoint_every=4)
    ref_svc = service.ClusteringService(
        workdir(mods, "pre_ref_"), **kw).start()
    try:
        ref, _ = _drive(mods, ref_svc, work, "cuda-kernel")
    finally:
        ref_svc.stop()
    work_pre = workdir(mods, "pre_")
    svc = service.ClusteringService(work_pre, **kw).start()
    client = serve_mine.MiningClient(service=svc)
    handles = [client.submit(t, a, x, params=p, executor="cuda-kernel")
               for t, a, x, p in work]
    deadline = time.time() + 120
    job_id = None
    while time.time() < deadline:
        job_id = handles[0].job_id
        if job_id is not None:
            job = svc.executor.jobs.get(job_id)
            if job is not None and (job.step or 0) >= 1:
                break   # a checkpoint past step 0 exists: mid-run
        time.sleep(0.005)
    svc.stop(preempt=True)
    check(job_id is not None, "preemption: no batch job formed")
    state = svc.executor.jobs.get(job_id).state
    check(str(getattr(state, "value", state)) == "SUSPENDED",
          f"preemption: job {job_id} ended {state}, not SUSPENDED")
    svc2 = service.ClusteringService(work_pre, **kw)
    outcomes = svc2.resume_suspended()
    svc2.stop()
    check(len(outcomes) == 1 and not outcomes[0].suspended
          and outcomes[0].resumed, f"preemption: resume gave {outcomes}")
    by_id = dict(zip(outcomes[0].request_ids, outcomes[0].results))
    check(sorted(by_id) == sorted(h.request_id for h in handles),
          f"preemption: the suspended job held requests {sorted(by_id)}")
    got = [by_id[h.request_id] for h in handles]
    for r, p in zip(got, ref):
        check(bool((r["labels"] == p["labels"]).all())
              and r["iterations"] == p["iterations"] == PREEMPT_ITERS,
              "preemption: resumed labels differ from the uninterrupted run")
    log(f"preemption: service job {job_id} SUSPENDED mid-run on the card, "
        f"resumed in a fresh service to the uninterrupted labels "
        f"({PREEMPT_ITERS} iterations, resume {outcomes[0].exec_s:.3f} s)")


def _dist_preempt(mods, label, req, reg_from, reg_to, expected) -> None:
    """A batch of one oversized request run by a BatchExecutor on
    ``reg_from``'s distributed lane, preempted after its second sharded
    checkpoint, then resumed by a fresh executor on ``reg_to``'s: labels
    (and K-Means iterations) equal to ``expected``."""
    service, cancel = mods["service"], mods["cancel"]
    tenant, algo, x, params = req
    wd = workdir(mods, "dist_pre_")
    q = service.AdmissionQueue()
    batcher = service.MicroBatcher(
        q, max_batch=1, max_wait_s=0.0, oversized=lambda r: reg_from.oversized(
            r.algo, r.n_points, r.features, r.params))
    q.submit(service.MiningRequest(tenant=tenant, algo=algo, data=x,
                                   params=dict(params)))
    (batch,) = batcher.poll()
    check(batch.oversized, f"{label}: the batch is not oversized")
    ex = service.BatchExecutor(wd, registry=reg_from, checkpoint_every=2)
    token = cancel.CancellationToken()

    def hook(job_id, item, events):
        if events == 2:   # mid-item, after a sharded checkpoint
            token.cancel(cancel.CancelReason.PREEMPTION)

    out = ex.run_batch(batch, token=token, progress_hook=hook)
    check(out.suspended and out.executor == "distributed",
          f"{label}: not suspended mid-shard ({out.executor})")
    shards_from = out.plan["shards"]
    outs = service.BatchExecutor(wd, registry=reg_to,
                                 checkpoint_every=2).resume_suspended()
    check(len(outs) == 1 and outs[0].resumed and not outs[0].suspended
          and outs[0].executor == "distributed",
          f"{label}: resume gave {outs}")
    got = outs[0].results[0]
    check(bool((got["labels"] == expected["labels"]).all()),
          f"{label}: resumed labels differ")
    if algo == "kmeans":
        check(got["iterations"] == expected["iterations"],
              f"{label}: {got['iterations']} iterations, uninterrupted "
              f"{expected['iterations']}")
    log(f"distributed {label}: suspended mid-shard at p = {shards_from}, "
        f"resumed at p = {outs[0].plan['shards']} to the uninterrupted "
        f"labels (resume {outs[0].exec_s:.3f} s)")


def distributed_path(torch, mods, counters) -> dict:
    """4d: the distributed lane on the card, no fallback.  (a) A DBSCAN
    request of 100,000 points at the default budget is routed to
    ``distributed`` with no flag; labels equal the one-job fit on the card
    of the same padded points.  (b) The same points through
    ``sharded_dbscan_fit_resumable`` on 4 shards of the card: the same
    labels, 16 cross launches a ring call.  (c) A K-Means request of 2^20
    points routed there by a 256 MiB budget, at 1 and 4 shards: labels and
    iterations equal the ``cuda-kernel`` lane's.  (d) Both algorithms
    preempted mid-shard at 4 shards and resumed at 1.  Each run's wall
    (profiler on), device busy share and launches are logged; returns the
    launches over the whole path."""
    import numpy as np
    service, dist, dbscan = mods["service"], mods["dist"], mods["dbscan"]
    serve_mine = mods["serve_mine"]
    names = ("epsilon_degree_cross", "expand_frontier_cross",
             "fused_masked_assign_update", "reduce_partials",
             "epsilon_degree", "expand_frontier")
    launches = dict.fromkeys(names, 0)

    def run(label, fn) -> dict:
        reset(counters)
        prof = profile_window(torch, f"distributed {label}", fn)
        got = {k: counters[k].launches for k in names}
        for k in names:
            launches[k] += got[k]
        log(f"distributed {label}: wall {prof['wall_ms'] / 1e3:.3f} s "
            f"(profiler on), device busy {prof['busy_ms'] / 1e3:.3f} s = "
            f"{prof['busy_ms'] / prof['wall_ms']:.3f} of the wall, "
            f"launches {got}")
        return got

    def served(reg, label, req, executor=None, **kw) -> dict:
        """One request through a card service (auto-routed unless
        ``executor``); its result."""
        tenant, algo, x, params = req
        svc = service.ClusteringService(
            workdir(mods, "dist_svc_"), registry=reg, device=DEV,
            max_wait_s=0.005, bucket_policy="pow2", **kw).start()
        out = {}
        try:
            def drive():
                h = serve_mine.MiningClient(service=svc).submit(
                    tenant, algo, x, params=params, executor=executor)
                out["r"] = h.result(900)
            out["launches"] = run(label, drive)
        finally:
            svc.stop()
        check(out["r"]["executor"] == (executor or "distributed"),
              f"distributed {label}: served by {out['r']['executor']}")
        return out

    mesh4 = card_mesh(mods, DIST_SHARDS)

    def registry(budget=None, mesh=None):
        reg = service.default_registry(device_budget_bytes=budget,
                                       device=DEV)
        if mesh is not None:
            reg.register(service.DistributedParadigm(device=DEV, mesh=mesh))
        return reg

    # --- (a) DBSCAN routed with no flag ------------------------------------
    db_req, x_pad = _dist_dbscan_request(mods)
    x = db_req[2]
    n, n_max = x.shape[0], x_pad.shape[0]
    cfg = dbscan.DBSCANConfig(eps=db_req[3]["eps"],
                              min_pts=db_req[3]["min_pts"])
    check(registry().oversized("dbscan", n, x.shape[1], db_req[3]),
          "dbscan 100,000 points: not over the default budget")
    a = served(registry(), "(a) DBSCAN 100,000 points, default budget",
               db_req)
    ra, got = a["r"], a["launches"]
    valid = torch.arange(n_max, device=DEV) < n
    one, _ = dbscan.fit_resumable(torch.from_numpy(x_pad).to(DEV), cfg,
                                  valid_mask=valid)
    labels_one = one.labels[:n].cpu().numpy()
    check(bool((ra["labels"] == labels_one).all()),
          "(a): distributed labels differ from the one-job fit on the card")
    nexp = int(one.expansions)
    check(got["epsilon_degree_cross"] == 1
          and got["expand_frontier_cross"] == nexp >= 1,
          f"(a): cross launches {got} for {nexp} expansions at p = 1")
    log(f"distributed (a): {n} points padded to {n_max}, "
        f"{int(ra['labels'].max())} clusters, {nexp} expansions, labels "
        f"equal to the one-job fit on the card")

    # --- (b) the same points on 4 shards -----------------------------------
    res = {}

    def fit4():
        res["b"], _ = dist.sharded_dbscan_fit_resumable(
            mesh4, x_pad, cfg, valid_mask=np.arange(n_max) < n)
        res["b"].labels.cpu()

    got = run("(b) DBSCAN on 4 shards of the card", fit4)
    # the host loop without the profiler: wall a BFS step at 1 and 4 shards
    for shards, mesh in ((1, card_mesh(mods, 1)), (DIST_SHARDS, mesh4)):
        wall = timed_wall(torch, lambda: dist.sharded_dbscan_fit_resumable(
            mesh, x_pad, cfg, valid_mask=np.arange(n_max) < n))
        log(f"distributed DBSCAN fit at {shards} shard(s), profiler off: "
            f"{wall:.4f} s for the degree and {nexp} BFS steps "
            f"({wall / (nexp + 1) * 1e3:.3f} ms a ring call)")
    check(bool((res["b"].labels[:n].cpu().numpy() == labels_one).all()),
          "(b): 4-shard labels differ from (a)")
    check(got["epsilon_degree_cross"] == 16
          and got["expand_frontier_cross"] == 16 * nexp,
          f"(b): cross launches {got}, want 16 a ring call ({nexp} "
          f"expansions)")

    # --- (c) K-Means routed by a budget, at 1 and 4 shards -----------------
    (km_req,) = serve_mine.build_workload(1, 1, "kmeans", seed=SEED + 12,
                                          **DIST_KMEANS)
    nk, dk = km_req[2].shape
    check(registry(DIST_KMEANS_BUDGET).oversized("kmeans", nk, dk, km_req[3])
          and not registry().oversized("kmeans", nk, dk, km_req[3]),
          "kmeans 2^20 points: the 256 MiB budget does not route it")
    lane = served(registry(), "(c) K-Means 2^20 points on cuda-kernel",
                  km_req, executor="cuda-kernel")["r"]
    for shards, mesh in ((1, None), (DIST_SHARDS, mesh4)):
        c = served(registry(DIST_KMEANS_BUDGET, mesh),
                   f"(c) K-Means 2^20 points, 256 MiB budget, {shards} "
                   f"shard(s)", km_req)
        r, got = c["r"], c["launches"]
        check(bool((r["labels"] == lane["labels"]).all())
              and r["iterations"] == lane["iterations"],
              f"(c) at {shards} shard(s): labels or iterations "
              f"({r['iterations']} vs {lane['iterations']}) differ from "
              f"the cuda-kernel lane")
        check(got["fused_masked_assign_update"] == shards * r["iterations"]
              and got["reduce_partials"] == r["iterations"],
              f"(c) at {shards} shard(s): launches {got} for "
              f"{r['iterations']} iterations (want pass 1 once a shard, "
              f"pass 2 once, an iteration)")
        log(f"distributed (c) at {shards} shard(s): {r['iterations']} "
            f"iterations, labels and iterations equal to the cuda-kernel "
            f"lane's, inertia {r['inertia']!r} (lane {lane['inertia']!r})")

    # --- (d) preempted at 4 shards, resumed at 1 ---------------------------
    run("(d) DBSCAN preempted at 4 shards, resumed at 1",
        lambda: _dist_preempt(mods, "(d) DBSCAN", db_req,
                              registry(mesh=mesh4), registry(), ra))
    run("(d) K-Means preempted at 4 shards, resumed at 1",
        lambda: _dist_preempt(mods, "(d) K-Means", km_req,
                              registry(DIST_KMEANS_BUDGET, mesh4),
                              registry(DIST_KMEANS_BUDGET), lane))
    for k in ("epsilon_degree_cross", "expand_frontier_cross",
              "fused_masked_assign_update"):
        check(launches[k] > 0, f"distributed path: {k} never launched")
    return launches


class CardMemory:
    """The card's peak used memory over a window, every process on it
    counted (free memory from ``cudaMemGetInfo``, sampled by a thread)."""

    def __init__(self, torch, every_s: float = 0.1) -> None:
        import threading
        self.torch, self.every_s = torch, every_s
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        free, total = self.torch.cuda.mem_get_info()
        self.peak = max(self.peak, total - free)

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self._sample()

    def __enter__(self) -> "CardMemory":
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *_exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self._sample()


def _timed_results(waits) -> list:
    """Each wait's result and the wall clock when it came back, waited on
    together (a fleet handle's fetch blocks in its own thread)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(wait):
        out = wait(900)
        return out, time.time()

    with ThreadPoolExecutor(max_workers=max(1, len(waits))) as pool:
        return list(pool.map(one, waits))


def _kernel_launches(router) -> dict:
    """Each live worker's kernel launch counters (its own process's, from
    its ``/snapshot``)."""
    return {name: snap["kernel_launches"]
            for name, snap in router.metrics_snapshot()["workers"].items()}


def _launch_delta(before: dict, after: dict) -> dict:
    """Launches per kernel between two readings, summed over the workers
    alive at both; a worker is read just before the phase drives it."""
    out: dict = {}
    for name, counts in after.items():
        base = before.get(name, {k: 0 for k in counts})
        for kernel, n in counts.items():
            out[kernel] = out.get(kernel, 0) + n - base[kernel]
    return out


def _scrape(port: int) -> str:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        return resp.read().decode("utf-8")


def _fleet_config(warm) -> dict:
    return dict(device=DEV, continuous=True, bucket_policy="pow2",
                warm_start=warm, **FLEET_LIVE)


def fleet_reference(mods) -> tuple:
    """The fleet phases' requests and their labels per content hash from an
    uninterrupted single-process service on the card (``cuda-kernel``)."""
    serve_mine, service = mods["serve_mine"], mods["service"]
    n_km = FLEET_VICTIM_REQUESTS + FLEET_LIVE_KMEANS
    km = _svc_workload(serve_mine, "kmeans", SVC_KMEANS, SEED + 11,
                       requests=n_km)
    db = _svc_workload(serve_mine, "dbscan", SVC_DBSCAN, SEED + 12,
                       requests=FLEET_LIVE_DBSCAN)
    work = km + db
    n_max = max(w[2].shape[0] for w in km)
    warm = [{"algo": "kmeans", "features": SVC_KMEANS["features"],
             "n": n_max, "k": SVC_KMEANS["clusters"], "max_iters": 50,
             "executor": "cuda-kernel"}]
    svc = _svc(mods, workdir(mods, "fleet_ref_"), warm_start=warm)
    svc.start()
    try:
        results, wall = _drive(mods, svc, work, "cuda-kernel")
    finally:
        svc.stop()
    ref = {service.content_key(a, p, x): r["labels"]
           for (_t, a, x, p), r in zip(work, results)}
    log(f"fleet reference: {len(work)} requests on one card service in "
        f"{wall:.3f} s (K-Means sizes {[w[2].shape[0] for w in km]}, "
        f"DBSCAN sizes {[w[2].shape[0] for w in db]})")
    return work, ref, warm


def fleet_failover(torch, mods, work, ref, warm) -> dict:
    """Phase A: a 3-worker fleet on the card loses a worker that holds
    durably admitted requests; a survivor adopts its WAL and every admitted
    request resolves to the single-process labels, on ``cuda-kernel``."""
    service = mods["service"]
    km = [w for w in work if w[1] == "kmeans"]
    db = [w for w in work if w[1] == "dbscan"]
    victim_work = km[:FLEET_VICTIM_REQUESTS]
    live_work = km[FLEET_VICTIM_REQUESTS:] + db
    root = workdir(mods, "fleet_")
    manager = service.WorkerManager(
        root, FLEET_WORKERS, worker_config=_fleet_config(warm),
        overrides={FLEET_VICTIM: dict(FLEET_ADMIT_ONLY)},
        heartbeat_interval=0.25, miss_deadline=FLEET_MISS_DEADLINE)
    t0 = time.time()
    with CardMemory(torch) as mem:
        try:
            manager.start()
            spawn = {n: round(w.spawn_s, 3)
                     for n, w in manager.workers.items()}
            log(f"fleet: {FLEET_WORKERS} workers on the card in "
                f"{time.time() - t0:.3f} s, spawn (Popen to announce) "
                f"{spawn} s, spawn_timeout {manager.spawn_timeout:.0f} s; "
                f"seconds from Popen to the end of each start-up phase "
                + json.dumps({n: {k: round(v, 3) for k, v in
                                  w.startup.items()}
                              for n, w in manager.workers.items()}))
            router = service.FleetRouter(manager)
            exporter = router.serve_metrics(0)
            try:
                out = _fleet_drive(mods, manager, router, exporter,
                                   victim_work, live_work, ref)
            finally:
                exporter.stop()
                router.close()
        finally:
            manager.stop()
    log(f"fleet failover phase: {time.time() - t0:.3f} s wall, card memory "
        f"peak {mem.peak / 2**30:.3f} GiB (every process on the card)")
    return dict(out, spawn_s=spawn, peak_gib=mem.peak / 2**30)


def _fleet_drive(mods, manager, router, exporter, victim_work, live_work,
                 ref) -> dict:
    import numpy as np

    service = mods["service"]
    tenants = [f"tenant-{i}" for i in range(400)]
    victim_tenants = [t for t in tenants
                      if router.ring.primary(t) == FLEET_VICTIM]
    live_tenants = [t for t in tenants
                    if router.ring.primary(t) != FLEET_VICTIM]
    before = _kernel_launches(router)
    t_wall = time.time()
    # durable admits on the victim, one after another (so bounded load
    # never spills them off their idle primary): the ACK is the WAL fsync
    victim, admit_s = [], []
    for tenant, (_t, algo, x, params) in zip(victim_tenants, victim_work):
        t0 = time.time()
        h = router.submit(tenant, algo, x, params=params,
                          executor="cuda-kernel", durable=True)
        ack = h.admitted(600)
        admit_s.append(round(time.time() - t0, 3))
        check(ack["worker"] == FLEET_VICTIM,
              f"fleet: a victim request was admitted at {ack['worker']}")
        victim.append(h)
    log(f"fleet: {len(victim)} durable K-Means requests admitted at "
        f"{FLEET_VICTIM} (RPC + WAL fsync, ~"
        f"{victim_work[0][2].nbytes / 2**20:.0f} MiB each): {admit_s} s")
    live = [router.submit(t, algo, x, params=params, executor="cuda-kernel")
            for t, (_t, algo, x, params) in zip(live_tenants, live_work)]
    t_kill = time.time()
    manager.fail_worker(FLEET_VICTIM)      # SIGKILL + synchronous takeover
    takeover = manager.takeovers[0] if manager.takeovers else {}
    log(f"fleet: SIGKILL {FLEET_VICTIM} with {len(live)} live requests in "
        f"flight; takeover {time.time() - t_kill:.3f} s: "
        + json.dumps({k: takeover.get(k) for k in
                      ("victim", "adopter", "replayed", "cache_hits",
                       "rejected", "pending_after", "error")}))
    done = _timed_results([h.result for h in victim + live])
    wall = time.time() - t_wall
    failover_s = max(t for _r, t in done[:len(victim)]) - t_kill
    lost = mismatched = 0
    for (_t, algo, x, params), (r, _ts) in zip(victim_work + live_work, done):
        key = service.content_key(algo, params, x)
        check(r["executor"] == "cuda-kernel",
              f"fleet: a request resolved on {r['executor']}")
        if r.get("labels") is None:
            lost += 1
        elif not np.array_equal(r["labels"], ref[key]):
            mismatched += 1
    check(lost == 0, f"fleet: {lost} admitted request(s) lost")
    check(mismatched == 0,
          f"fleet: {mismatched} request(s) differ from the single-process "
          f"labels")
    check(int(takeover.get("replayed", 0)) >= len(victim),
          f"fleet: takeover replayed {takeover.get('replayed')} of "
          f"{len(victim)} admitted at the victim")
    replaced = {t: router.place(t) for t in victim_tenants[:len(victim)]}
    check(all(w != FLEET_VICTIM for w in replaced.values()),
          f"fleet: victim tenants not re-placed: {replaced}")
    wal = service.RequestLog(os.path.join(manager.root, FLEET_VICTIM, "wal"))
    pending = wal.pending()
    wal.close()
    check(pending == 0, f"fleet: victim WAL has {pending} pending admits")
    text = _scrape(exporter.port)
    errors = service.exposition_errors(text)
    check(not errors, f"fleet exposition: {errors}")
    for needle in (f'repro_fleet_worker_up{{worker="{FLEET_VICTIM}"}} 0.0',
                   'repro_fleet_worker_up{worker="worker-1"} 1.0',
                   'repro_fleet_worker_up{worker="worker-2"} 1.0',
                   'repro_fleet_worker_requests_total{worker="',
                   "repro_fleet_takeover_replayed_total{",
                   "repro_fleet_takeovers_total 1"):
        check(needle in text, f"fleet exposition lacks {needle}")
    snap = router.metrics_snapshot()
    per_worker = {n: (ws.get("totals") or {}).get("requests", 0)
                  for n, ws in snap["workers"].items()}
    launches = _launch_delta(before, _kernel_launches(router))
    for kernel in ("fused_masked_assign_update", "epsilon_degree",
                   "expand_frontier"):
        check(launches.get(kernel, 0) >= 1,
              f"fleet: no {kernel} launch in the survivors")
    log(f"fleet failover: wall {wall:.3f} s, failover (SIGKILL to the last "
        f"adopted result) {failover_s:.3f} s, lost {lost}, mismatched "
        f"{mismatched}, all on cuda-kernel, requests per worker "
        f"{per_worker}, victim tenants re-placed {replaced}, victim WAL "
        f"pending {pending}, exposition {len(text)} bytes valid; "
        f"survivors' launches {launches}")
    return dict(launches=launches, admit_s=admit_s, failover_s=failover_s)


def standby_promotion(torch, mods, counters, work, ref, warm) -> dict:
    """Phase B, first half: a primary worker process on the card admits
    durable K-Means requests while a WalShipper mirrors its WAL to a
    StandbyReplica hosted here; at zero lag the primary is SIGKILLed and
    the standby promoted on the card."""
    import numpy as np

    service = mods["service"]
    km = [w for w in work if w[1] == "kmeans"][:STANDBY_REQUESTS]
    standby = service.StandbyReplica(workdir(mods, "standby_")).start()
    manager = service.WorkerManager(
        workdir(mods, "primary_"), 1,
        worker_config=dict(_fleet_config(warm), **FLEET_ADMIT_ONLY),
        standbys={"worker-0": f"127.0.0.1:{standby.port}"})
    out = {}
    with CardMemory(torch) as mem:
        try:
            manager.start()
            log(f"standby: primary worker on the card, spawn "
                f"{manager.workers['worker-0'].spawn_s:.3f} s")
            router = service.FleetRouter(manager)
            t_ship = time.time()
            admit_s = []
            try:
                for tenant, algo, x, params in km:
                    t0 = time.time()
                    router.submit(tenant, algo, x, params=params,
                                  executor="cuda-kernel",
                                  durable=True).admitted(600)
                    admit_s.append(round(time.time() - t0, 3))
            finally:
                router.close()
            t_admitted = time.time()
            deadline = t_admitted + 600
            while time.time() < deadline:
                snap = standby.stats()
                if (snap["pending_entries"] >= len(km)
                        and snap["lag_entries"] == 0):
                    break
                time.sleep(0.05)
            t_caught = time.time()
            snap = standby.stats()
            lag = snap["lag_entries"]
            manager.fail_worker("worker-0")      # SIGKILL: the machine is lost
        finally:
            manager.stop(drain=False)
        check(lag == 0 and snap["pending_entries"] >= len(km),
              f"standby: lag {lag} entries, {snap['pending_entries']} pending "
              f"before the kill")
        log(f"standby: {len(km)} durable requests admitted in {admit_s} s; "
            f"{snap['bytes_applied']} bytes shipped in {snap['applies']} "
            f"chunks, zero lag {t_caught - t_admitted:.3f} s after the last "
            f"ACK ({t_caught - t_ship:.3f} s from the first submit); lag at "
            f"the kill {lag} entries")
        text = _scrape(standby.port)
        errors = service.exposition_errors(text)
        check(not errors, f"replica exposition: {errors}")
        for needle in ("repro_replica_lag_entries",
                       "repro_replica_pending_entries",
                       "repro_replica_applies_total", "repro_replica_ok 1"):
            check(needle in text, f"replica exposition lacks {needle}")
        reset(counters)
        t0 = time.time()
        svc, summary = standby.promote(
            device=DEV, max_batch=SVC_MAX_BATCH, max_wait_s=0.005,
            continuous=True, bucket_policy="pow2", warm_start=warm)
        try:
            done = _timed_results([r.wait for r in summary["requests"]])
            first = min(t for _r, t in done) - t0
            launches = {k: counters[k].launches
                        for k in ("fused_masked_assign_update",)}
            check(summary["replayed"] == len(km),
                  f"standby: promote replayed {summary['replayed']} of "
                  f"{len(km)}")
            for req, (r, _t) in zip(summary["requests"], done):
                check(r["executor"] == "cuda-kernel",
                      f"standby: a request resolved on {r['executor']}")
                check(bool(np.array_equal(r["labels"], ref[req.cache_key])),
                      "standby: promoted labels differ from the "
                      "single-process labels")
            check(launches["fused_masked_assign_update"] >= 1,
                  "standby: the promoted service launched no fused kernel")
            pending = svc.wal.pending()
            check(pending == 0, f"standby: promoted WAL has {pending} "
                                f"pending admits")
            svc.apply_config({"tenant_rate": 50.0})
            msnap = svc.metrics_snapshot()
            check(msnap["config"]["epoch"] == 1,
                  f"standby: config epoch {msnap['config']['epoch']} after "
                  f"a reload")
            check("repro_config_epoch 1" in
                  service.render_prometheus(msnap),
                  "standby: the exposition lacks repro_config_epoch 1")
        finally:
            svc.stop(drain=True)
    out.update(launches=launches, promote_s=round(time.time() - t0, 3),
               first_result_s=first, admit_s=admit_s,
               bytes_shipped=snap["bytes_applied"])
    log(f"standby promoted on the card: {summary['replayed']} replayed, "
        f"first result {first:.3f} s after promote(), labels equal, all on "
        f"cuda-kernel, launches {launches}, reload epoch 1; card memory "
        f"peak {mem.peak / 2**30:.3f} GiB")
    return out


def rolling_restart(torch, mods, work, ref, warm) -> dict:
    """Phase B, second half: a 2-worker fleet on the card restarted one
    worker at a time under durable load, with a fleet-wide reload."""
    import numpy as np

    service = mods["service"]
    km = [w for w in work if w[1] == "kmeans"][:STANDBY_REQUESTS]
    manager = service.WorkerManager(
        workdir(mods, "roll_"), ROLL_WORKERS,
        worker_config=_fleet_config(warm), heartbeat_interval=0.25,
        miss_deadline=FLEET_MISS_DEADLINE)
    with CardMemory(torch) as mem:
        router = None
        try:
            manager.start()
            router = service.FleetRouter(manager)
            first = router.reload({"tenant_rate": 77.0})
            check(first["converged"]
                  and set(first["epochs"].values()) == {1},
                  f"roll: fleet reload {first}")
            pids = {n: w.pid for n, w in manager.workers.items()}
            handles = [router.submit(t, a, x, params=p,
                                     executor="cuda-kernel", durable=True)
                       for t, a, x, p in km]
            for h in handles:
                h.admitted(600)
            t0 = time.time()
            restarts = manager.rolling_restart(drain_timeout=600.0)
            roll_s = time.time() - t0
            mismatched = 0
            for (_t, a, x, p), h in zip(km, handles):
                r = h.result(900)
                check(r["executor"] == "cuda-kernel",
                      f"roll: a request resolved on {r['executor']}")
                if not np.array_equal(r["labels"],
                                      ref[service.content_key(a, p, x)]):
                    mismatched += 1
            check(mismatched == 0, f"roll: {mismatched} request(s) differ "
                                   f"from the single-process labels")
            new = {n: w.pid for n, w in manager.workers.items()}
            check(all(new[n] != pids[n] for n in pids)
                  and len(restarts) == ROLL_WORKERS,
                  f"roll: pids {pids} -> {new}")
            again = router.reload({"tenant_rate": 77.0})
            check(again["converged"]
                  and len(set(again["epochs"].values())) == 1
                  and len(again["epochs"]) == ROLL_WORKERS,
                  f"roll: fleet reload after the roll {again}")
            # the restarted fleet serves: one new request, its launches
            # read from the successors just before and just after
            before = _kernel_launches(router)
            t, a, x, p = km[0]
            post = router.submit(t, a, x, params=dict(p, seed=9999),
                                 executor="cuda-kernel").result(900)
            check(post["executor"] == "cuda-kernel",
                  "roll: the restarted fleet did not serve on cuda-kernel")
            launches = _launch_delta(before, _kernel_launches(router))
            check(launches["fused_masked_assign_update"] >= 1,
                  "roll: the successors launched no fused kernel")
        finally:
            if router is not None:
                router.close()
            manager.stop()
    times = {r["worker"]: round(r["duration_s"], 3) for r in restarts}
    log(f"rolling restart on the card: {len(km)} durable requests across "
        f"the roll, labels equal, pids {pids} -> {new}, restart time per "
        f"worker (drain + respawn) {times} s, roll {roll_s:.3f} s, reload "
        f"epochs {first['epochs']} then {again['epochs']}; a request after "
        f"the roll launched {launches}; card memory peak "
        f"{mem.peak / 2**30:.3f} GiB")
    return dict(restart_s=times, launches=launches)


def small_checks(torch, mods) -> None:
    mine, dbscan, synth, cancel = (mods["mine"], mods["dbscan"], mods["synth"],
                                   mods["cancel"])
    x, _, _ = synth.make_blobs(3, synth.ClusterSpec(2, 6, 256), device=DEV)
    cfg = dbscan.DBSCANConfig.paper_defaults(2)
    res = dbscan.fit(x, cfg)
    oracle = dbscan.fit_oracle(x.cpu().numpy(), cfg)
    check(bool((res.labels.cpu().numpy() == oracle).all()),
          "small dbscan on the card differs from the sequential oracle")
    log(f"oracle: small dbscan on the card equals the oracle "
        f"({int(res.n_clusters)} clusters)")
    tok = cancel.CancellationToken()
    tok.cancel()
    out = mine.run_mining_job(algo="kmeans", features=2, clusters=4, size=128,
                              workdir=workdir(mods, "cancel_"),
                              token=tok, device=DEV)
    check(out["final_state"] == "SUSPENDED" and out["cancelled"],
          f"cancelled job ended {out['final_state']}")
    log("cancel: pre-cancelled job ended SUSPENDED")


def load_modules() -> tuple:
    """The port's modules every phase reads (``mods``) and the kernel
    wrappers whose launches the paths count (``counters``)."""
    from repro_torch.core import dbscan, kmeans
    from repro_torch.core import cancellation as cancel
    from repro_torch.core import distributed as dist
    from repro_torch.data import synthetic as synth
    from repro_torch import configs
    from repro_torch.kernels.attention import ops as aops, ref as aref
    from repro_torch.kernels.distance import fused as fops
    from repro_torch.kernels.distance import ops as dops, ref as dref
    from repro_torch.kernels.neighbor import ops as nops, ref as nref
    from repro_torch.launch import mine, serve, serve_mine
    from repro_torch.launch import train as launch_train
    from repro_torch.models import frontends, layers, lm, moe
    from repro_torch import optim, service
    from repro_torch.checkpoint import store
    from repro_torch.train import step as tstep
    from repro_torch.tree import tree_map
    from repro_torch.examples import (embedding_clustering, mine_cluster,
                                      quickstart, service_demo)
    from repro_torch.launch import cells, dryrun, dryrun_cluster
    from repro_torch.parallel import pipeline
    from repro_torch.parallel.sharding import AbstractMesh
    from repro_torch.tree import tree_leaves

    mods = dict(dops=dops, dref=dref, fops=fops, nops=nops, nref=nref,
                synth=synth, mine=mine, kmeans=kmeans, dbscan=dbscan,
                cancel=cancel, serve_mine=serve_mine, service=service,
                aops=aops, aref=aref, serve=serve, lm=lm, layers=layers,
                moe=moe, frontends=frontends,
                configs=configs, dist=dist, tstep=tstep, optim=optim,
                launch_train=launch_train, store=store, tree_map=tree_map,
                ex_quickstart=quickstart, ex_mine_cluster=mine_cluster,
                ex_service_demo=service_demo,
                ex_embedding=embedding_clustering, cells=cells,
                dryrun=dryrun, dryrun_cluster=dryrun_cluster,
                pipeline=pipeline, AbstractMesh=AbstractMesh,
                tree_leaves=tree_leaves)
    counters = {"assign_clusters": dops.assign_clusters,
                "fused_masked_assign_update": fops.fused_masked_assign_update,
                "epsilon_degree": nops.epsilon_degree,
                "expand_frontier": nops.expand_frontier,
                "epsilon_degree_cross": nops.epsilon_degree_cross,
                "expand_frontier_cross": nops.expand_frontier_cross,
                "reduce_partials": fops.reduce_partials,
                "lloyd_sums": fops.lloyd_sums,
                "flash_attention": aops.flash_attention}
    return mods, counters


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.runtime import backend

    mods, counters = load_modules()
    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    backend.load("cuda")  # fp32 matmul at "highest", no TF32
    # every job store, WAL and checkpoint of the run lives under one
    # scratch root (in TMPDIR), removed however the run ends
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     ignore_cleanup_errors=True) as tmp:
        mods["tmp"] = tmp
        try:
            sass = build(_build)
            rows = [kernel_assign(torch, mods, sass["distance"]),
                    kernel_fused(torch, mods, sass["fused"]),
                    kernel_lloyd(torch, mods)]
            wide_rows(torch, mods)
            rows += [*kernel_neighbor(torch, mods, sass["neighbor"]),
                     *kernel_cross(torch, mods, sass["neighbor"]),
                     *kernel_attention(torch, mods, sass["flash_sm90"])]
            t_path = time.time()
            mine_launches = main_path(torch, mods, counters)
            log(f"one-job path: {time.time() - t_path:.1f} s, launches "
                f"{mine_launches}")
            t_path = time.time()
            svc_launches = service_path(torch, mods, counters)
            log(f"service path: {time.time() - t_path:.1f} s, launches "
                f"{svc_launches}")
            t_path = time.time()
            lm_launches = lm_serving_path(torch, mods, counters)
            log(f"LM serving path: {time.time() - t_path:.1f} s, launches "
                f"{lm_launches}")
            train = training_path(torch, mods, counters, card)
            train_launches = train["launches"]
            ex_launches, ex_row, ex_assign = examples_path(
                torch, mods, counters, card)
            rows.append(ex_row)
            families = lm_families_path(torch, mods, counters, card)
            fam_launches = {
                "flash_attention_internvl2":
                    families["internvl2-26b"]["flash"],
                "flash_attention_musicgen":
                    families["musicgen-medium"]["flash"],
                "flash_attention_olmoe": families["olmoe-1b-7b"]["flash"],
                "flash_attention_gqa32_8":
                    families["phi3.5-moe-42b-a6.6b"]["flash"]
                    + families["jamba-v0.1-52b"]["flash"],
                "flash_attention_phi3": families["phi3-mini-3.8b"]["flash"],
                "flash_attention_glm4": families["glm4-9b"]["flash"],
                "flash_attention_minicpm": families["minicpm-2b"]["flash"]}
            fam_train = family_training_path(torch, mods, counters, card)
            fam_train_launches = {
                "flash_attention_olmoe":
                    fam_train["olmoe-1b-7b"]["prefill_flash"],
                "flash_attention_musicgen":
                    fam_train["musicgen-medium"]["prefill_flash"],
                "flash_attention_phi3":
                    fam_train["phi3-mini-3.8b"]["prefill_flash"]}
            t_path = time.time()
            service_preemption(mods)
            small_checks(torch, mods)
            log(f"preemption + small checks: {time.time() - t_path:.1f} s")
            t_path = time.time()
            dist_launches = distributed_path(torch, mods, counters)
            log(f"distributed path: {time.time() - t_path:.1f} s, launches "
                f"{dist_launches}")
            t_path = time.time()
            work, ref, warm = fleet_reference(mods)
            fleet = fleet_failover(torch, mods, work, ref, warm)
            log(f"fleet path: {time.time() - t_path:.1f} s, survivors' "
                f"launches {fleet['launches']}")
            t_path = time.time()
            standby = standby_promotion(torch, mods, counters, work, ref,
                                        warm)
            roll = rolling_restart(torch, mods, work, ref, warm)
            log(f"standby + rolling restart path: {time.time() - t_path:.1f}"
                f" s, promoted launches {standby['launches']}, successors' "
                f"launches {roll['launches']}")
            pod_launches, pod_row = pod_path(torch, mods, counters, card,
                                             train)
            rows.append(pod_row)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
            return 1
    # launches: from the newest path that runs the kernel (the assignment
    # kernel only runs on the one-job path)
    launches = dict(mine_launches)
    launches.update({k: v for k, v in svc_launches.items()
                     if k != "assign_clusters"})
    launches.update(lm_launches)
    launches.update({k: v for k, v in dist_launches.items()
                     if k.endswith("_cross")})
    launches["assign_clusters_d2048"] = ex_assign
    launches.update(fam_launches)
    for name, n in fam_train_launches.items():
        launches[name] += n
    launches["fused_masked_partials_pod"] = pod_launches[
        "fused_masked_assign_update"]
    # the narrow-row sums run on the examples' one-job fits alone
    launches["lloyd_sums"] = ex_launches["lloyd_sums"]
    ex_launches = dict(ex_launches, assign_clusters_d2048=ex_assign)
    for row in rows:
        row["launches"] = launches[row["name"]]
        log(json.dumps({"kernel": row["name"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "launches": row["launches"],
                        "launches_one_job_path": mine_launches.get(
                            row["name"]),
                        "launches_service_path": svc_launches.get(
                            row["name"]),
                        "launches_lm_path": lm_launches.get(row["name"]),
                        "launches_training_path": train_launches.get(
                            row["name"]),
                        "launches_distributed_path": dist_launches.get(
                            row["name"]),
                        "launches_examples_path": ex_launches.get(
                            row["name"]),
                        "launches_lm_families_path": fam_launches.get(
                            row["name"]),
                        "launches_training_families_path":
                            fam_train_launches.get(row["name"]),
                        "launches_pod_path": (
                            pod_launches["fused_masked_assign_update"]
                            if row["name"] == "fused_masked_partials_pod"
                            else None),
                        "max_err": row["max_abs_err"],
                        "library_ms": row["library_ms"],
                        "library_call": row.get("library_call"),
                        "kernel_only_ms": row.get("kernel_only_ms"),
                        "launch_shape": row.get("launch_shape"),
                        "search": row.get("search"),
                        "bound_fp32_ms": row.get("bound_fp32_ms"),
                        "block_error": row.get("block_error"),
                        "simt_ms": row.get("simt_ms"),
                        "simt_max_abs_err": row.get("simt_max_abs_err"),
                        "simt_block_error": row.get("simt_block_error"),
                        "sass": row.get("sass"),
                        "rechecks": row.get("rechecks"),
                        "ring_rechecks_per_pair": row.get(
                            "ring_rechecks_per_pair"),
                        "device_ms": row.get("device_ms"),
                        "host_us": row.get("host_us"),
                        "events_ms": row.get("events_ms"),
                        "library_events_ms": row.get("library_events_ms"),
                        "library_host_us": row.get("library_host_us"),
                        "shapes": row.get("shapes"),
                        "shape": row["shape"], "card": card}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total: {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
