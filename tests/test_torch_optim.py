"""Port parity: LR schedules, AdamW and the gradient codecs
(``repro_torch.optim``) against the reference's ``repro.optim``.

Inputs are numpy arrays drawn from a seed and handed to both packages.
Tolerances: schedules 1e-7 at every step of the grid; AdamW 1e-6 relative
on identical params and grads; the int8 all-reduce within one int8 step
(the shared scale) of the mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.core.distributed import Mesh
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.optim import schedule as tschedule
from repro_torch.tree import tree_leaves

SCHED_TOL = 1e-7
ADAMW_RTOL = 1e-6


# -- schedules -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["wsd", "cosine", "constant"])
@pytest.mark.parametrize("total", [1, 7, 100, 1000])
def test_schedule_matches_reference(name, total):
    """Against the reference's schedule evaluated op by op.  (Jitted, XLA
    fuses the cosine schedule and its cos moves by up to 1.2e-7 from the
    same function run op by op, at total 1000 — two float32 ulps.)"""
    jf = jschedule.make_schedule(name, total)
    tf = tschedule.make_schedule(name, total)
    steps = sorted(set(range(0, min(total, 50) + 3))
                   | set(range(0, total + 3, max(1, total // 37))))
    for s in steps:
        ref = float(jf(jnp.int32(s)))
        port = tf(torch.tensor(s, dtype=torch.int32))
        assert port.dtype == torch.float32
        assert abs(float(port) - ref) <= SCHED_TOL, (name, total, s)
        assert float(tf(s)) == float(port)   # a Python int works too


def test_schedule_keyword_options_match_reference():
    for name, kw in (("wsd", dict(warmup_frac=0.1, decay_frac=0.3,
                                  final_scale=0.0)),
                     ("cosine", dict(warmup_frac=0.2, final_scale=0.5))):
        jf = jschedule.make_schedule(name, 50, **kw)
        tf = tschedule.make_schedule(name, 50, **kw)
        for s in range(53):
            assert abs(float(tf(s)) - float(jf(s))) <= SCHED_TOL, (name, s)
    assert set(tschedule.SCHEDULES) == set(jschedule.SCHEDULES)


# -- AdamW ---------------------------------------------------------------------


def _both(tree_np, bf16=False):
    jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if bf16
                                            else jnp.float32), tree_np)
    tt = jax.tree.map(lambda a: torch.tensor(a, dtype=torch.bfloat16 if bf16
                                             else torch.float32), tree_np)
    return jt, tt


def _assert_close_tree(port, ref, rtol=ADAMW_RTOL):
    pl = [np.asarray(x.float()) for x in tree_leaves(port)]
    rl = [np.asarray(x, np.float32) for x in jax.tree.leaves(ref)]
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(
            1e-30, float(np.abs(b).max())))


def test_adamw_bf16_master_weights():
    params = {"w": torch.ones((64,), dtype=torch.bfloat16)}
    state = tadamw.adamw_init(params)
    assert "master" in state and state["master"]["w"].dtype == torch.float32
    grads = {"w": torch.full((64,), 0.1, dtype=torch.bfloat16)}
    cfg = tadamw.AdamWConfig(lr=1e-2, weight_decay=0.0)
    p2, s2, m = tadamw.adamw_update(cfg, params, grads, state)
    assert p2["w"].dtype == torch.bfloat16
    assert float(m["grad_norm"]) > 0
    # master moved against the gradient
    assert float(s2["master"]["w"][0]) < 1.0
    # against the reference on the same inputs
    jp = {"w": jnp.ones((64,), jnp.bfloat16)}
    jp2, js2, jm = jadamw.adamw_update(
        jadamw.AdamWConfig(lr=1e-2, weight_decay=0.0), jp,
        {"w": jnp.full((64,), 0.1, jnp.bfloat16)}, jadamw.adamw_init(jp))
    _assert_close_tree(s2["master"], js2["master"])
    _assert_close_tree(p2, jp2)
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        ADAMW_RTOL * float(jm["grad_norm"])


def test_adamw_grad_clip():
    params = {"w": torch.zeros((4,), dtype=torch.float32)}
    state = tadamw.adamw_init(params)
    huge = {"w": torch.full((4,), 1e6)}
    cfg = tadamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    p2, s2, m = tadamw.adamw_update(cfg, params, huge, state)
    assert torch.isfinite(p2["w"]).all()
    # clipped: first-step Adam update is bounded by lr
    assert float(p2["w"].abs().max()) <= 1.0 + 1e-5
    jp2, _js, _jm = jadamw.adamw_update(
        jadamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0),
        {"w": jnp.zeros((4,))}, {"w": jnp.full((4,), 1e6)},
        jadamw.adamw_init({"w": jnp.zeros((4,))}))
    _assert_close_tree(p2, jp2)


def test_adamw_decreases_quadratic():
    params = {"w": torch.full((8,), 5.0)}
    state = tadamw.adamw_init(params)
    cfg = tadamw.AdamWConfig(lr=0.5, weight_decay=0.0)
    jparams = {"w": jnp.full((8,), 5.0)}
    jstate = jadamw.adamw_init(jparams)
    jcfg = jadamw.AdamWConfig(lr=0.5, weight_decay=0.0)
    for _ in range(50):
        params, state, _ = tadamw.adamw_update(cfg, params,
                                               {"w": 2 * params["w"]}, state)
        jparams, jstate, _ = jadamw.adamw_update(
            jcfg, jparams, {"w": 2 * jparams["w"]}, jstate)
    assert float(params["w"].abs().max()) < 1.0
    _assert_close_tree(params, jparams)


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_matches_reference_on_a_tree(bf16):
    """Several leaves, weight decay, a schedule scale, three steps with
    fresh gradients each: params, moments, master, count and metrics."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    params_np = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp, tp = _both(params_np, bf16)
    cfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=0.5)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(3):
        g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3
                                       ).astype(np.float32), params_np)
        jg, tg = _both(g_np, bf16)
        jp, js, jm = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), jp, jg,
                                         js, 0.5)
        tp, ts, tm = tadamw.adamw_update(tadamw.AdamWConfig(**cfg), tp, tg,
                                         ts, 0.5)
        for key in ("mu", "nu") + (("master",) if bf16 else ()):
            _assert_close_tree(ts[key], js[key])
        # bf16 params: the same master rounds to the same bf16 value
        _assert_close_tree(tp, jp)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                ADAMW_RTOL * abs(float(jm[k])), k


def test_adamw_updates_in_place():
    params = {"w": torch.randn(6, generator=torch.Generator().manual_seed(0))}
    params["w"].requires_grad_(True)
    before = params["w"]
    state = tadamw.adamw_init(params)
    new, state, _ = tadamw.adamw_update(tadamw.AdamWConfig(), params,
                                        {"w": torch.ones(6)}, state)
    assert new["w"] is before and before.requires_grad


# -- gradient compression codecs ----------------------------------------------


def test_int8_codec_roundtrip_error():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1024)
                         .astype(np.float32))
    q, scale = tcompress.int8_encode(g, torch.Generator().manual_seed(1))
    rec = tcompress.int8_decode(q, scale)
    # quantization error bounded by scale/2 + stochastic noise
    assert float((rec - g).abs().max()) <= float(scale) * 1.5
    assert q.dtype == torch.int8
    _jq, jscale = jcompress.int8_encode(jnp.asarray(g.numpy()),
                                        jax.random.PRNGKey(1))
    assert abs(float(scale) - float(jscale)) <= 1e-7 * float(jscale)


def test_int8_rounding_is_unbiased():
    g = torch.full((20000,), 0.3)
    g[0] = 127.0   # scale 1: each entry rounds to 0 or 1
    q, scale = tcompress.int8_encode(g, torch.Generator().manual_seed(2))
    assert float(scale) == pytest.approx(1.0)
    assert abs(float(q[1:].float().mean()) - 0.3) < 0.02


def test_topk_codec_keeps_largest():
    g_np = np.array([0.1, -5.0, 0.2, 3.0, -0.05], np.float32)
    g = torch.from_numpy(g_np)
    vals, idx, residual = tcompress.topk_encode(g, frac=0.4)  # k=2
    rec = tcompress.topk_decode(vals, idx, g.shape)
    assert float(rec[1]) == -5.0 and float(rec[3]) == 3.0
    assert float(rec[0]) == 0.0
    # error feedback residual holds the rest
    assert torch.equal(rec + residual, g)
    jv, ji, jr = jcompress.topk_encode(jnp.asarray(g_np), frac=0.4)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(
        jcompress.topk_decode(jv, ji, g_np.shape)))
    np.testing.assert_array_equal(residual.numpy(), np.asarray(jr))


def _grad_trees(p, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((33, 5)).astype(np.float32) * (i + 1),
             "b": {"c": rng.standard_normal((9,)).astype(np.float32)}}
            for i in range(p)]


@pytest.mark.parametrize("p", [1, 4])
def test_compressed_psum_int8_is_the_mean_within_one_step(p):
    trees = _grad_trees(p)
    mesh = Mesh(("cpu",) * p)
    shards = [jax.tree.map(torch.from_numpy, t) for t in trees]
    out = tcompress.compressed_psum_int8(mesh, shards)
    for path in (("w",), ("b", "c")):
        leaves = [t[path[0]] if len(path) == 1 else t[path[0]][path[1]]
                  for t in trees]
        got = out[path[0]] if len(path) == 1 else out[path[0]][path[1]]
        mean = np.mean(leaves, axis=0)
        step = max(float(np.abs(x).max()) for x in leaves) / 127.0
        assert got.device == mesh.devices[0]
        assert float(np.abs(got.numpy() - mean).max()) <= step


def test_compressed_psum_int8_one_shard_matches_reference():
    from jax.sharding import Mesh as JaxMesh

    (tree,) = _grad_trees(1, seed=3)
    jmesh = JaxMesh(np.array(jax.devices()[:1]), ("data",))
    ref = jcompress.compressed_psum_int8(
        jmesh, jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(0),
        ("data",))
    port = tcompress.compressed_psum_int8(
        Mesh(("cpu",)), [jax.tree.map(torch.from_numpy, tree)])
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_compressed_psum_int8_checks_its_mesh():
    mesh = Mesh(("cpu",) * 2)
    with pytest.raises(ValueError, match="2 shards"):
        tcompress.compressed_psum_int8(mesh, [{"w": torch.ones(2)}])
    with pytest.raises(ValueError, match="axis"):
        tcompress.compressed_psum_int8(mesh, [{"w": torch.ones(2)}] * 2,
                                       axes=("model",))
