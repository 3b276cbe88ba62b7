"""The port's dry-run (``repro_torch.launch.{cells,dryrun,dryrun_cluster}``)
and the dry-run clustering step, against the reference where they share a
meaning.

- ``iter_cells()`` gives the reference's 40 cells, 32 live.
- Per-device argument bytes of every live cell on both production meshes
  equal the local shard bytes of the port's arguments laid out by the
  reference's own layouts (its ``rules_for``, ``tree_specs``,
  ``zero1_spec`` and ``spec_for_shape`` on a duck-typed mesh).  Documented
  differences: the train state's ``rng`` is a host generator state and the
  decode position a Python int (neither is on the device), and token ids
  are int64 (8 bytes where the reference's are 4).
- The meta traces on each arch's smoke config at a (2, 4) mesh: every
  record key present, no kernel launched, and the FLOPs of the dense train
  and prefill cells equal a closed form written out from the widths.
- ``clustering_step_for_dryrun`` of both packages on the same inputs:
  assignments equal, ``c_new`` within 1e-5, shift and inertia within 1e-4
  relative.
"""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.core import distributed as jdist
from repro.core.kmeans import KMeansConfig as JaxKMeansConfig
from repro.launch import cells as jcells
from repro.models import lm as jlm
from repro.parallel import resolve as jresolve
from repro.parallel import sharding as jsharding
from repro.train import step as jstep
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import distributed as tdist
from repro_torch.core.kmeans import KMeansConfig
from repro_torch.kernels.attention import ops as aops
from repro_torch.kernels.distance import fused, ops as dops
from repro_torch.kernels.neighbor import ops as nops
from repro_torch.launch import cells, dryrun, dryrun_cluster
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

LIVE = [(a, s) for a, s, ok, _ in dryrun.iter_cells() if ok]


def test_iter_cells_counts_the_reference_cells():
    all_cells = list(dryrun.iter_cells())
    assert len(all_cells) == 40
    assert len(LIVE) == 32


# -- argument bytes against the reference's layouts ---------------------------


def _local(spec, shape, duck):
    entries = list(spec) + [None] * (len(shape) - len(spec))
    n = 1
    for ent, dim in zip(entries, shape):
        axes = () if ent is None else (ent,) if isinstance(ent, str) else ent
        size = int(np.prod([duck.shape[a] for a in axes]))
        assert dim % size == 0
        n *= dim // size
    return n


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _bytes(jspecs, port_tree, duck):
    """Bytes of the port's leaves laid out by the reference's specs (a
    tree, or already flat)."""
    leaves = _flat(port_tree)
    specs = jspecs if jspecs.keys() == leaves.keys() else _flat(jspecs)
    assert specs.keys() == leaves.keys()
    return sum(_local(specs[p], tuple(leaves[p].shape), duck)
               * leaves[p].itemsize for p in specs)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", LIVE)
def test_argument_bytes_equal_the_reference_layouts(arch, shape, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    duck = types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=mesh.shape)
    cell = cells.build_cell(arch, shape, mesh)
    jcfg = jax_config(arch)
    jshape = [s for s in JAX_SHAPES if s.name == shape][0]
    jrules = jcells.rules_for(jcfg, jshape, tp=mesh.shape["model"])
    b, s = jshape.global_batch, jshape.seq_len

    def batch_bytes(batch):
        total = 0
        for name, t in batch.items():
            axes = (("batch", "seq", "embed") if name == "prefix_embeds"
                    else ("batch", "seq"))
            spec = jsharding.spec_for_shape(jrules, axes, duck,
                                            tuple(t.shape))
            total += _local(spec, tuple(t.shape), duck) * t.itemsize
        return total

    jparams = jresolve.tree_specs(jlm.param_axes(jcfg),
                                  jlm.abstract_params(jcfg), duck, jrules)
    if jshape.kind == "train":
        state, batch = cell.args
        jabs = jstep.abstract_train_state(jcfg)
        jbase = jresolve.tree_specs(jstep.train_state_axes(jcfg), jabs, duck,
                                    jrules)
        want = _bytes(jbase.params, state.params, duck)
        for key in state.opt:
            if key == "count":
                want += state.opt["count"].itemsize
                continue
            z1 = {p: jresolve.zero1_spec(sp, tuple(a.shape), duck)
                  for (p, sp), a in zip(_flat(jbase.opt[key]).items(),
                                        _flat(jabs.opt[key]).values())}
            want += _bytes(z1, state.opt[key], duck)
        want += state.step.itemsize + batch_bytes(batch)
    elif jshape.kind == "prefill":
        params, batch = cell.args
        want = _bytes(jparams, params, duck) + batch_bytes(batch)
    else:
        params, cache, tok, _pos = cell.args
        jcache = jresolve.tree_specs(jlm.cache_axes(jcfg, b, s),
                                     jlm.abstract_decode_cache(jcfg, b, s),
                                     duck, jrules)
        want = (_bytes(jparams, params, duck) + _bytes(jcache, cache, duck)
                + batch_bytes({"tokens": tok}))
    assert cells.argument_bytes(cell) == want


def test_zero3_shards_the_params_over_the_data_axes():
    mesh = make_production_mesh()
    base = cells.build_cell("jamba-v0.1-52b", "train_4k", mesh)
    z3 = cells.build_cell("jamba-v0.1-52b", "train_4k", mesh,
                          rule_overrides={"_zero3": True})
    params = cells.tree_bytes((base.args[0].params,),
                              (base.specs[0].params,), mesh)
    params3 = cells.tree_bytes((z3.args[0].params,), (z3.specs[0].params,),
                               mesh)
    assert params3 < params / 8
    assert cells.argument_bytes(z3) == \
        cells.argument_bytes(base) - params + params3
    assert dryrun.cell_collectives(z3)["per_op"]["all-gather"]["count"] > \
        dryrun.cell_collectives(base)["per_op"]["all-gather"]["count"]


# -- meta traces --------------------------------------------------------------

SMALL = {"train": ShapeSpec("train_s", 32, 32, "train"),
         "prefill": ShapeSpec("prefill_s", 64, 4, "prefill"),
         "decode": ShapeSpec("decode_s", 64, 16, "decode")}
RECORD_KEYS = ("arch", "shape", "mesh", "devices", "tag", "status",
               "n_params", "n_active_params", "n_groups", "local_batch",
               "memory_analysis", "cost_analysis", "collectives",
               "analysis_depth1", "analysis_depth2", "derived")
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes",
               "temp_is_upper_bound")


def _smoke_fields(arch, **change):
    cfg = get_smoke_config(arch)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(change)
    return fields


def _launches():
    return (aops.flash_attention.launches, dops.assign_clusters.launches,
            fused.fused_masked_assign_update.launches,
            fused.reduce_partials.launches, nops.epsilon_degree.launches,
            nops.expand_frontier.launches)


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_meta_trace_records(arch, kind):
    before = _launches()
    rec = dryrun.run_cell(arch, SMALL[kind], False, mesh=make_test_mesh(
        (2, 4)), cfg_overrides=_smoke_fields(arch))
    assert _launches() == before
    for key in RECORD_KEYS:
        assert key in rec, key
    for key in MEMORY_KEYS:
        assert key in rec["memory_analysis"], key
    assert rec["status"] == "ok" and rec["mesh"] == "mesh_2x4"
    assert rec["devices"] == 8
    assert rec["local_batch"] == SMALL[kind].global_batch // 2
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["derived"]["flops"] == rec["cost_analysis"]["flops"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["memory_analysis"]["temp_is_upper_bound"]   # model = 4
    assert set(rec["collectives"]) >= {"per_op", "total_wire_bytes"}
    assert rec["collectives"]["total_wire_bytes"] > 0
    json.dumps(rec)


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in ("olmo-1b", "olmoe-1b-7b", "falcon-mamba-7b",
                     "jamba-v0.1-52b") for k in sorted(SMALL)
    if (a, k) != ("jamba-v0.1-52b", "train")])   # 20 s of meta trace
def test_derived_totals_match_a_full_depth_trace(arch, kind):
    """FLOPs derived from depths period and 2 period equal a trace at 3
    periods; so do a prefill's and a decode's temps.  A train step's temps
    grow by what each group keeps for the backward, not by the same bytes
    from group to group: the linear derivation stays within 25% of the
    full-depth trace on these configs."""
    period = get_smoke_config(arch).period
    rec = dryrun.run_cell(arch, SMALL[kind], False,
                          mesh=make_test_mesh((2, 4)),
                          cfg_overrides=_smoke_fields(arch,
                                                      n_layers=3 * period))
    cell = cells.build_cell(arch, SMALL[kind], make_test_mesh((2, 4)),
                            cfg_overrides=_smoke_fields(
                                arch, n_layers=3 * period))
    full = cells.trace_cell(cell)
    assert rec["derived"]["flops"] == full["flops"]
    temp = rec["memory_analysis"]["temp_size_in_bytes"]
    if kind == "train":
        assert temp == pytest.approx(full["temp_size_in_bytes"], rel=0.25)
    else:
        assert temp == full["temp_size_in_bytes"]


def _dense_widths(cfg, local_batch, seq):
    t = local_batch * seq
    d, h, kv, dh = cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads_padded, \
        cfg.d_head
    # q, k, v and out projections; the three SwiGLU matrices
    proj = 2 * t * d * (h * dh + 2 * kv * dh) + 2 * t * h * dh * d
    mlp = 3 * 2 * t * d * cfg.d_ff
    return t, proj, mlp


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_dense_train_flops_match_the_closed_form(remat):
    arch = "olmo-1b"
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    rec = dryrun.run_cell(arch, SMALL["train"], False,
                          mesh=make_test_mesh((2, 4)),
                          cfg_overrides=_smoke_fields(arch, remat=remat))
    b, s = rec["local_batch"], SMALL["train"].seq_len
    t, proj, mlp = _dense_widths(cfg, b, s)
    # training attention (_sdpa): q.k and p.v over the whole square
    attn = 4 * b * cfg.n_heads_padded * s * s * cfg.d_head
    w_down = 2 * t * cfg.d_ff * cfg.d_model
    # forward + backward (two products per product), plus what the remat
    # policy recomputes: "full" the whole group except its last product,
    # whose output the backward never reads (non-reentrant checkpoint stops
    # early); "dots" the batched attention products only
    layer = 3 * (proj + mlp + attn)
    layer += {"full": proj + mlp + attn - w_down, "dots": attn,
              "none": 0}[remat]
    # the tied head in chunked CE (16 rows, one a chunk): forward, the
    # chunk's recompute, and the backward's two products
    head = 4 * 2 * t * cfg.d_model * cfg.vocab_padded
    closed = cfg.n_layers * layer + head
    assert b == 16 and cfg.loss_chunk == 16
    assert rec["cost_analysis"]["flops"] == pytest.approx(closed, rel=1e-2)


def test_dense_prefill_flops_match_the_closed_form():
    arch = "olmo-1b"
    cfg = get_smoke_config(arch)
    rec = dryrun.run_cell(arch, SMALL["prefill"], False,
                          mesh=make_test_mesh((2, 4)),
                          cfg_overrides=_smoke_fields(arch))
    b, s = rec["local_batch"], SMALL["prefill"].seq_len
    t, proj, mlp = _dense_widths(cfg, b, s)
    # the flash kernel's shape op: 4 D a causal pair
    flash = 4 * cfg.d_head * b * cfg.n_heads_padded * s * (s + 1) // 2
    head = 2 * b * cfg.d_model * cfg.vocab_padded    # the last position
    closed = cfg.n_layers * (proj + mlp + flash) + head
    assert rec["cost_analysis"]["flops"] == pytest.approx(closed, rel=1e-2)


def test_trace_leaves_arguments_and_outputs_out_of_temps():
    x = torch.empty((1024, 256), device="meta")
    w = torch.empty((256, 256), device="meta")

    def step(x, w):
        h = x @ w           # 1 MiB, freed before the next product ends
        return (h @ w) @ w  # the output (1 MiB) is not a temporary

    out = cells.trace_step(step, (x, w))
    assert out["flops"] == 3 * 2 * 1024 * 256 * 256
    assert out["temp_size_in_bytes"] == 2 * 1024 * 256 * 4


def test_dryrun_main_writes_a_record(tmp_path, capsys):
    dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    path = tmp_path / "single_pod_16x16" / "falcon-mamba-7b__long_500k.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["local_batch"] == 1
    assert "1 ok, 0 failed" in capsys.readouterr().out


# -- the pod-scale K-Means cell and the dry-run clustering step ---------------


def test_kmeans_cell_counts_the_fused_passes():
    rec = dryrun_cluster.kmeans_cell(make_production_mesh())
    n, d, k = (dryrun_cluster.KMEANS_N // 16, dryrun_cluster.KMEANS_D,
               dryrun_cluster.KMEANS_K)
    blocks = -(-n // fused.block_rows(n, k, d))
    assert rec["local_batch"] == n
    assert rec["cost_analysis"]["flops"] == \
        2 * n * k * d + n * d + blocks * (k * d + k + 1)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        n * d * 4 + k * d * 4
    ar = rec["collectives"]["per_op"]["all-reduce"]
    assert ar["count"] == 1 and ar["result_bytes"] == (k * d + k + 1) * 4
    one = dryrun_cluster.kmeans_cell(make_test_mesh((1,), ("data",)))
    assert one["memory_analysis"]["argument_size_in_bytes"] == \
        dryrun_cluster.KMEANS_N * d * 4 + k * d * 4
    assert one["collectives"]["total_wire_bytes"] == 0


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_clustering_step_for_dryrun_matches_the_reference(use_kernel,
                                                          shards):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4096, 16)).astype(np.float32) * 3.0
    c = x[rng.choice(4096, 32, replace=False)].copy()
    ja, jc, jshift, jinert = jdist.clustering_step_for_dryrun(
        JaxKMeansConfig(k=32, use_kernel=False))(jnp.asarray(x),
                                                 jnp.asarray(c))
    step = tdist.clustering_step_for_dryrun(
        KMeansConfig(k=32, use_kernel=use_kernel),
        tdist.Mesh(("cpu",) * shards))
    a, cn, shift, inert = step(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(cn.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(shift), float(jshift), rtol=1e-4)
    np.testing.assert_allclose(float(inert), float(jinert), rtol=1e-4)


def test_clustering_step_for_dryrun_on_meta_launches_nothing():
    before = _launches()
    x = torch.empty((1 << 20, 128), device="meta")
    c = torch.empty((4096, 128), device="meta")
    a, cn, shift, inert = tdist.clustering_step_for_dryrun(
        KMeansConfig(k=4096), tdist.Mesh(("meta",) * 2))(x, c)
    assert _launches() == before
    assert a.shape == (1 << 20,) and a.dtype == torch.int32
    assert cn.shape == (4096, 128) and shift.shape == inert.shape == ()
