"""Port parity: the sharding layer (``repro_torch.parallel``), the abstract
trees of the dry-run, the GPipe pipeline and the HLO collective parser,
against the reference's ``repro.parallel`` / ``repro.launch``.

The reference's layout functions read only ``axis_names`` and ``shape``
of a mesh, so they run here on a duck-typed mesh with no forced devices
(``SimpleNamespace``); its ``PartitionSpec`` and the port's ``Spec`` are
compared as tuples.  Every live (arch x shape) cell on the single-pod
(16, 16), multi-pod (2, 16, 16) and (2, 4) test meshes: the rules, the
parameter layouts, the ZeRO-1 layouts of the optimizer state and the
decode cache's layouts are equal.  The pipeline runs the reference's own
case on a mesh of four host shards: outputs within 2e-5 and gradients
within 1e-4 of the sequential run, and its outputs within 2e-5 of the
reference's ``pipeline_apply`` on 4 forced host devices (a subprocess).
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import cell_applicable as jax_applicable
from repro.launch import cells as jcells
from repro.launch import hlo as jhlo
from repro.models import lm as jlm
from repro.parallel import resolve as jresolve
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.configs.base import shape_by_name
from repro_torch.core.distributed import Mesh
from repro_torch.launch import cells, hlo
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import lm
from repro_torch.parallel import resolve
from repro_torch.parallel.pipeline import pipeline_apply, split_stages
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    AbstractMesh,
    Spec,
    lshard,
    logical_to_spec,
    spec_for_shape,
)
from repro_torch.train import step as tstep

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "test_2x4": ((2, 4), ("data", "model"))}
LIVE = [(arch, s.name)
        for arch in ("internvl2-26b", "minicpm-2b", "olmo-1b",
                     "phi3-mini-3.8b", "glm4-9b", "olmoe-1b-7b",
                     "phi3.5-moe-42b-a6.6b", "musicgen-medium",
                     "falcon-mamba-7b", "jamba-v0.1-52b")
        for s in JAX_SHAPES if jax_applicable(jax_config(arch), s)[0]]


def _meshes(name):
    sizes, axes = MESHES[name]
    duck = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    return duck, AbstractMesh(axes, sizes)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (a leaf: anything else)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same_specs(ref_tree, port_tree):
    ref, port = _flat(ref_tree), _flat(port_tree)
    assert ref.keys() == port.keys()
    for path in ref:
        assert tuple(ref[path]) == tuple(port[path]), (path, ref[path],
                                                       port[path])


def test_live_cells_are_the_reference_count():
    assert len(LIVE) == 32


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", LIVE)
def test_specs_equal_the_reference(arch, shape, mesh_name):
    duck, mesh = _meshes(mesh_name)
    jcfg, cfg = jax_config(arch), get_config(arch)
    jshape, tshape = [s for s in JAX_SHAPES if s.name == shape][0], \
        shape_by_name(shape)
    tp = mesh.shape.get("model", 1)
    jrules = jcells.rules_for(jcfg, jshape, tp=tp)
    rules = cells.rules_for(cfg, tshape, tp=tp)
    assert rules.table == jrules.table

    # parameters
    jparams = jresolve.tree_specs(jlm.param_axes(jcfg),
                                  jlm.abstract_params(jcfg), duck, jrules)
    params = resolve.tree_specs(lm.param_axes(cfg), lm.abstract_params(cfg),
                                mesh, rules)
    _same_specs(jparams, params)

    if tshape.kind == "train":
        # ZeRO-1 over the optimizer state, and ZeRO-3 over the params
        jabs = jstep.abstract_train_state(jcfg)
        jbase = jresolve.tree_specs(jstep.train_state_axes(jcfg), jabs, duck,
                                    jrules)
        state = resolve.train_state_shardings(
            tstep.train_state_axes(cfg), tstep.abstract_train_state(cfg),
            mesh, rules)
        for key in ("mu", "nu", "master"):
            assert (key in jbase.opt) == (key in state.opt)
            if key in state.opt:
                jz = {p: jresolve.zero1_spec(s, tuple(a.shape), duck)
                      for (p, s), a in zip(_flat(jbase.opt[key]).items(),
                                           _flat(jabs.opt[key]).values())}
                _same_specs(jz, _flat(state.opt[key]))
        _same_specs(jbase.params, state.params)
        z3 = resolve.train_state_shardings(
            tstep.train_state_axes(cfg), tstep.abstract_train_state(cfg),
            mesh, rules, zero3=True)
        jz3 = {p: jresolve.zero1_spec(s, tuple(a.shape), duck)
               for (p, s), a in zip(_flat(jbase.params).items(),
                                    _flat(jabs.params).values())}
        _same_specs(jz3, _flat(z3.params))

    if tshape.kind == "decode":
        b, s = tshape.global_batch, tshape.seq_len
        jcache = jresolve.tree_specs(jlm.cache_axes(jcfg, b, s),
                                     jlm.abstract_decode_cache(jcfg, b, s),
                                     duck, jrules)
        cache = resolve.tree_specs(lm.cache_axes(cfg, b, s),
                                   lm.abstract_decode_cache(cfg, b, s), mesh,
                                   rules)
        _same_specs(jcache, cache)


def test_the_reference_sharding_asserts():
    """tests/test_parallel.py:_SHARDING_SCRIPT's four asserts, on the
    port's (2, 4) mesh."""
    mesh = make_test_mesh((2, 4), ("data", "model"))
    # divisible: heads 8 on model=4
    s = spec_for_shape(DEFAULT_RULES, ("embed", "heads", "head_dim"), mesh,
                       (64, 8, 16))
    assert s == Spec(None, "model"), s
    # non-divisible heads 6 -> dropped, fan-in fallback puts model on embed
    s = resolve.spec_for_decl(DEFAULT_RULES, ("embed", "heads", "head_dim"),
                              (64, 6, 16), mesh)
    assert s == Spec("model"), s
    # batch over (pod, data): pod absent -> data only
    s = spec_for_shape(DEFAULT_RULES, ("batch", "seq"), mesh, (16, 128))
    assert s == Spec("data"), s
    # batch=1: unshardable -> replicated
    s = spec_for_shape(DEFAULT_RULES, ("batch", "seq"), mesh, (1, 128))
    assert s == Spec(), s


def test_spec_drops_trailing_none_and_lshard_is_the_identity():
    assert tuple(Spec("data", None, None)) == ("data",)
    assert Spec(None, ("pod", "data")) == (None, ("pod", "data"))
    assert logical_to_spec(DEFAULT_RULES, ("batch", "seq")) == \
        Spec(("pod", "data"))
    x = torch.ones(3)
    assert lshard(x, "batch") is x
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512
    assert make_production_mesh().shape == {"data": 16, "model": 16}


# -- abstract trees -----------------------------------------------------------

ARCHS = sorted({a for a, _ in LIVE})


def _same_shapes(ref_tree, port_tree):
    ref, port = _flat(ref_tree), _flat(port_tree)
    assert ref.keys() == port.keys()
    for path in ref:
        r, p = ref[path], port[path]
        assert tuple(r.shape) == tuple(p.shape), path
        assert str(r.dtype) == str(p.dtype).removeprefix("torch."), (
            path, r.dtype, p.dtype)
        assert p.device.type == "meta", path


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    _same_shapes(jlm.abstract_params(jcfg), lm.abstract_params(cfg))
    _same_shapes(jlm.abstract_decode_cache(jcfg, 2, 64),
                 lm.abstract_decode_cache(cfg, 2, 64))
    assert _flat(jlm.cache_axes(jcfg, 2, 64)) == \
        _flat(lm.cache_axes(cfg, 2, 64))

    jstate, state = jstep.abstract_train_state(jcfg), \
        tstep.abstract_train_state(cfg)
    _same_shapes(jstate.params, state.params)
    _same_shapes(jstate.opt, state.opt)
    _same_shapes({"step": jstate.step}, {"step": state.step})
    # documented difference: rng is the host generator's state (uint8)
    assert state.rng.device.type == "cpu" and state.rng.dtype == torch.uint8

    jbatch = jstep.train_batch_shapes(jcfg, 4, 4096)
    batch = tstep.train_batch_shapes(cfg, 4, 4096)
    assert jbatch.keys() == batch.keys()
    for name in batch:
        assert tuple(jbatch[name].shape) == tuple(batch[name].shape), name
    # documented difference: int64 token ids, as the port's train step takes
    for name in ("tokens", "labels"):
        assert str(jbatch[name].dtype) == "int32"
        assert batch[name].dtype == torch.int64
    if "prefix_embeds" in batch:
        assert batch["prefix_embeds"].dtype == torch.bfloat16


# -- pipeline -----------------------------------------------------------------

L_, D_, M_, MB_ = 8, 16, 6, 4


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L_, D_, D_)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M_, MB_, D_)).astype(np.float32)
    return ws, xs


def _stage_fn(params, x):
    for w in params:
        x = torch.tanh(x @ w)
    return x


def _sequential(ws, xs):
    y = xs
    for i in range(L_):
        y = torch.tanh(y @ ws[i])
    return y


def test_pipeline_matches_the_sequential_run():
    ws_np, xs_np = _pipeline_inputs()
    mesh = Mesh(("cpu",) * 4, axis="pipe")
    ws = torch.from_numpy(ws_np).requires_grad_(True)
    xs = torch.from_numpy(xs_np)
    out = pipeline_apply(mesh, _stage_fn)(split_stages(ws, 4), xs)
    ref = _sequential(ws, xs)
    assert out.shape == (M_, MB_, D_)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    # gradients flow back through the stages (the backward is pipelined)
    g, = torch.autograd.grad(torch.sum(out ** 2), ws)
    g_ref, = torch.autograd.grad(torch.sum(ref ** 2), ws)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_pipeline_needs_whole_stages_and_its_axis():
    with pytest.raises(ValueError):
        split_stages(torch.zeros(6, 2), 4)
    with pytest.raises(ValueError):
        pipeline_apply(Mesh(("cpu",) * 2), _stage_fn)   # axis "data"


_REF_PIPELINE = textwrap.dedent(r"""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import sys; sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.parallel.pipeline import pipeline_apply, split_stages

    ws = np.load({ws!r}); xs = np.load({xs!r})
    mesh = jax.make_mesh((4,), ('pipe',))

    def stage_fn(params, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        y, _ = jax.lax.scan(body, x, params)
        return y

    staged = jax.device_put(split_stages(jnp.asarray(ws), 4),
                            NamedSharding(mesh, P('pipe')))
    out = jax.jit(pipeline_apply(mesh, stage_fn))(staged, jnp.asarray(xs))
    np.save({out!r}, np.asarray(out))
    print('PIPELINE_OK')
""")


def test_pipeline_matches_the_reference_pipeline(tmp_path):
    ws_np, xs_np = _pipeline_inputs()
    paths = {k: str(tmp_path / f"{k}.npy") for k in ("ws", "xs", "out")}
    np.save(paths["ws"], ws_np)
    np.save(paths["xs"], xs_np)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    done = subprocess.run(
        [sys.executable, "-c", _REF_PIPELINE.format(src=src, **paths)],
        capture_output=True, text=True, timeout=300, env=env)
    assert "PIPELINE_OK" in done.stdout, done.stderr[-3000:]
    ref = np.load(paths["out"])
    out = pipeline_apply(Mesh(("cpu",) * 4, axis="pipe"), _stage_fn)(
        split_stages(torch.from_numpy(ws_np), 4), torch.from_numpy(xs_np))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


# -- HLO collective inventory -------------------------------------------------

HLO_LINES = {
    "brace groups": "%all-reduce.1 = f32[128,256]{1,0} all-reduce(%p), "
                    "replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add",
    "iota groups": "%all-gather.2 = bf16[16,4096,128]{2,1,0} "
                   "all-gather(%x), replica_groups=[16,16]<=[256], "
                   "dimensions={0}",
    "tuple result": "%all-to-all = (f32[64]{0}, f32[64]{0}) all-to-all(%a, "
                    "%b), replica_groups={{0,1}}",
    "start and done": "%rs-start = f32[8,8]{1,0} reduce-scatter-start(%y), "
                      "replica_groups={{0,1,2,3,4,5,6,7}}\n"
                      "%rs-done = f32[8,8]{1,0} reduce-scatter-done("
                      "%rs-start)",
    "permute": "%collective-permute.3 = s32[1024]{0} collective-permute(%z)"
               ", source_target_pairs={{0,1},{1,2},{2,3},{3,0}}",
    "no group": "%all-reduce.9 = f32[2]{0} all-reduce(%q), to_apply=%add",
    "not a collective": "%add.1 = f32[4]{0} add(%a, %b)",
}


@pytest.mark.parametrize("what", sorted(HLO_LINES))
def test_hlo_collectives_equal_the_reference(what):
    text = HLO_LINES[what]
    assert hlo.analyze_collectives(text, 256) == \
        jhlo.analyze_collectives(text, 256)
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        assert hlo.wire_bytes(op, 4096, 8) == jhlo.wire_bytes(op, 4096, 8)


def test_all_hlo_lines_at_once_equal_the_reference():
    text = "\n".join(HLO_LINES.values())
    got = hlo.analyze_collectives(text, 8)
    assert got == jhlo.analyze_collectives(text, 8)
    assert got["per_op"]["reduce-scatter"]["count"] == 1
