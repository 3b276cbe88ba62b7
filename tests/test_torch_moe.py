"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe``.

Weights are the reference's ``init_params`` carried across with
``convert.lm_params_from_jax``; activations come from a numpy seed; fp32
smoke configs.  The reference's router decisions are read by running its
routing lines (``moe.py:81-90``) in jax and its dispatch rule
(``:98-108``) in numpy, on the reference's own probabilities.
Tolerances: outputs 1e-5, aux loss 1e-6, router ids and keep masks equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe as tmoe

OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4
MOE_ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b")


def _cfgs(arch, **change):
    return (dataclasses.replace(jax_smoke(arch), **change),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **change))


def _moe_params(jcfg, seed=0):
    """The first MoE sub-layer's params of layer 0, both packages."""
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    sub = next(i for i, (_m, ff) in enumerate(jcfg.pattern) if ff == "moe")
    jm = jax.tree.map(lambda p: p[0], jp["layers"][f"sub_{sub}"]["moe"])
    return jm, lm_params_from_jax(jax.tree.map(np.asarray, jm))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _ref_grouping(cfg, s, no_drop):
    """The reference's group and capacity (``moe.py:72-79``)."""
    k = cfg.top_k
    group = s if not cfg.moe_chunk else min(cfg.moe_chunk, s)
    if s % group != 0:
        group = s
    cap = max(8, -(-group * k // 8) * 8) if no_drop \
        else jmoe.capacity(cfg, group)
    return group, min(cap, group * k)


def _ref_keep(ids, cap, e):
    """The reference's dispatch rule on one (group, k) block of ids: sort
    the pairs by expert id stably, number them within their expert, keep
    those below capacity; back in (token, choice) order."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    counts = np.bincount(se, minlength=e)
    starts = np.cumsum(counts) - counts
    keep_sorted = (np.arange(flat.size) - starts[se]) < cap
    keep = np.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return keep.reshape(ids.shape)


def _ref_routing(jm, x, cfg, no_drop):
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jm["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _top_p, top_ids = jax.lax.top_k(probs, cfg.top_k)
    ids = np.asarray(top_ids)
    group, cap = _ref_grouping(cfg, x.shape[1], no_drop)
    keep = np.concatenate([
        np.stack([_ref_keep(ids[r, i:i + group], cap, cfg.n_experts)
                  for r in range(ids.shape[0])])
        for i in range(0, x.shape[1], group)], axis=1)
    return ids, keep


# -- declarations and capacity -------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decls_match_reference(arch):
    for get_t, get_j in ((tconfigs.get_smoke_config, jax_smoke),
                         (tconfigs.get_config, jax_config)):
        td, jd = tmoe.moe_decls(get_t(arch)), jmoe.moe_decls(get_j(arch))
        assert sorted(td) == sorted(jd)
        for key in td:
            a, b = td[key], jd[key]
            assert (a.shape, a.axes, a.init, a.scale) == \
                (b.shape, b.axes, b.init, b.scale), key


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 64.0])
def test_capacity_matches_reference(arch, cf):
    for get_t, get_j in ((tconfigs.get_smoke_config, jax_smoke),
                         (tconfigs.get_config, jax_config)):
        tcfg = dataclasses.replace(get_t(arch), capacity_factor=cf)
        jcfg = dataclasses.replace(get_j(arch), capacity_factor=cf)
        for n in (1, 3, 8, 13, 32, 100, 1024, 2048):
            assert tmoe.capacity(tcfg, n) == jmoe.capacity(jcfg, n)
            for no_drop in (False, True):
                assert tmoe.grouping(tcfg, n, no_drop) == \
                    _ref_grouping(jcfg, n, no_drop)


def test_moe_capacity_math():
    """The twin of tests/test_models.py::test_moe_capacity_math."""
    cfg = tconfigs.get_config("olmoe-1b-7b")
    c = tmoe.capacity(cfg, 1024)
    assert c >= 1024 * cfg.top_k // cfg.n_experts
    assert c % 8 == 0


def test_top_k_breaks_ties_to_the_lower_index_like_jax():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 8)).astype(np.float32) / 4
    probs[0] = 0.25   # every entry tied
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- moe_ffn against the reference ----------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 64.0])
@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "no_drop"])
@pytest.mark.parametrize("s,moe_chunk", [(32, 1024), (32, 8), (30, 8)],
                         ids=["one_group", "four_groups", "indivisible"])
def test_moe_ffn_matches_reference(arch, cf, no_drop, s, moe_chunk):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf, moe_chunk=moe_chunk)
    jm, tm = _moe_params(jcfg)
    x = _x(jcfg, 2, s, seed=5)
    ref, jaux = jmoe.moe_ffn(jm, jnp.asarray(x), jcfg, no_drop=no_drop)
    out, aux = tmoe.moe_ffn(tm, torch.from_numpy(x), tcfg, no_drop=no_drop)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    ids, keep = tmoe.routing(tm, torch.from_numpy(x), tcfg, no_drop=no_drop)
    rids, rkeep = _ref_routing(jm, x, jcfg, no_drop)
    np.testing.assert_array_equal(ids.numpy(), rids)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    if no_drop or cf == 64.0:
        assert bool(keep.all())
    elif moe_chunk > s:
        # capacity 0.5 over one group a row drops choices (groups of 8
        # tokens hold at least 8 slots an expert, so they cannot)
        assert not bool(keep.all())


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_ffn_matches_reference_per_activation(act):
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b", act=act)
    jm, tm = _moe_params(jcfg)
    assert ("w_gate" in tm) == (act == "swiglu")
    x = _x(jcfg, 3, 16, seed=6)
    ref, jaux = jmoe.moe_ffn(jm, jnp.asarray(x), jcfg)
    out, aux = tmoe.moe_ffn(tm, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


def test_moe_ffn_runs_the_same_bits_twice():
    _jcfg, tcfg = _cfgs("olmoe-1b-7b", capacity_factor=0.5, moe_chunk=8)
    _jm, tm = _moe_params(_jcfg)
    x = torch.from_numpy(_x(tcfg, 2, 32, seed=7))
    a, aux_a = tmoe.moe_ffn(tm, x, tcfg)
    b, aux_b = tmoe.moe_ffn(tm, x, tcfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_drop_vs_nodrop():
    """The twin of tests/test_models.py::test_moe_drop_vs_nodrop."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("olmoe-1b-7b"),
                              capacity_factor=0.5)
    from repro_torch.models import lm as tlm
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    sub = {k: v[0] for k, v in params["layers"]["sub_0"]["moe"].items()}
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y_drop, aux = tmoe.moe_ffn(sub, x, cfg)
    y_nodrop, _ = tmoe.moe_ffn(sub, x, cfg, no_drop=True)
    assert torch.isfinite(y_drop).all() and torch.isfinite(y_nodrop).all()
    assert float(aux) > 0.0
    # with tiny capacity, some tokens must have been dropped
    assert not torch.allclose(y_drop, y_nodrop)


def test_moe_all_tokens_routed_when_capacity_ample():
    """The twin of tests/test_models.py::
    test_moe_all_tokens_routed_when_capacity_ample."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("olmoe-1b-7b"),
                              capacity_factor=64.0)
    from repro_torch.models import lm as tlm
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    sub = {k: v[0] for k, v in params["layers"]["sub_0"]["moe"].items()}
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y1, _ = tmoe.moe_ffn(sub, x, cfg)
    y2, _ = tmoe.moe_ffn(sub, x, cfg, no_drop=True)
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("moe_chunk", [1024, 8], ids=["one_group",
                                                      "four_groups"])
def test_moe_gradients_match_reference(moe_chunk):
    jcfg, tcfg = _cfgs("olmoe-1b-7b", capacity_factor=0.5,
                       moe_chunk=moe_chunk)
    jm, tm = _moe_params(jcfg)
    x = _x(jcfg, 2, 32, seed=8)
    probe = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * probe) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(leaves, xt, tcfg)
    (torch.sum(y * torch.from_numpy(probe)) + aux).backward()
    for key, tv in leaves.items():
        ref = np.asarray(jg[key])
        scale = float(np.abs(ref).max())
        assert scale > 0
        assert float(np.abs(tv.grad.numpy() - ref).max()) <= GRAD_TOL * scale
    ref = np.asarray(jgx)
    assert float(np.abs(xt.grad.numpy() - ref).max()) <= \
        GRAD_TOL * float(np.abs(ref).max())
