"""The MoE FFN's backward pass (``repro_torch.models.moe``): gradients
against ``jax.grad`` through the reference's ``repro.models.moe.moe_ffn``,
``gradcheck`` in float64, and the rules of its order.

The dispatch and the combine move rows with ``moe._Rows``, whose backward
gathers and adds in a fixed order: a token's gradient from its k slots is
added in ascending expert id, the combine's order, and no float
scatter-add (whose atomics on the card add in whatever order they land)
runs anywhere in the backward.  Weights come from the reference's
``init_params`` through ``convert.lm_params_from_jax``; activations from a
numpy seed; fp32 smoke configs.  Tolerance: every gradient within 1e-4 of
its largest |g|, as tests/test_torch_moe.py holds the forward's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe as tmoe

GRAD_TOL = 1e-4
# (arch, top_k): the olmoe and phi3.5-moe smoke configs as they are, and
# olmoe's with every one of its 8 experts chosen, olmoe-1b-7b's published k
CASES = [("olmoe-1b-7b", None), ("phi3.5-moe-42b-a6.6b", None),
         ("olmoe-1b-7b", 8)]
CASE_IDS = ["olmoe", "phi35moe", "olmoe_top8"]


def _cfgs(arch, **change):
    return (dataclasses.replace(jax_smoke(arch), **change),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **change))


def _moe_params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    sub = next(i for i, (_m, ff) in enumerate(jcfg.pattern) if ff == "moe")
    jm = jax.tree.map(lambda p: p[0], jp["layers"][f"sub_{sub}"]["moe"])
    return jm, lm_params_from_jax(jax.tree.map(np.asarray, jm))


def _change(top_k, cf, moe_chunk):
    change = dict(capacity_factor=cf, moe_chunk=moe_chunk)
    if top_k is not None:
        change["top_k"] = top_k
    return change


@pytest.mark.parametrize("arch,top_k", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("cf", [0.5, 64.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("moe_chunk", [1024, 8], ids=["one_group",
                                                      "four_groups"])
def test_moe_backward_matches_jax_grad(arch, top_k, cf, moe_chunk):
    """Every parameter's gradient and the input's, with choices dropped at
    capacity 0.5 over one group a row and none at 64."""
    jcfg, tcfg = _cfgs(arch, **_change(top_k, cf, moe_chunk))
    jm, tm = _moe_params(jcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    probe = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * probe) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(leaves, xt, tcfg)
    (torch.sum(y * torch.from_numpy(probe)) + aux).backward()
    _ids, keep = tmoe.routing(tm, torch.from_numpy(x), tcfg)
    if cf == 64.0:
        assert bool(keep.all())
    elif moe_chunk > x.shape[1]:
        assert not bool(keep.all())   # the case has dropped choices
    for key, tv in leaves.items():
        ref = np.asarray(jg[key])
        scale = float(np.abs(ref).max())
        assert scale > 0
        assert float(np.abs(tv.grad.numpy() - ref).max()) <= \
            GRAD_TOL * scale, key
    ref = np.asarray(jgx)
    assert float(np.abs(xt.grad.numpy() - ref).max()) <= \
        GRAD_TOL * float(np.abs(ref).max())


def _tiny(k=2, e=4, cap=8, g=12, d=3, f=5, seed=0):
    """A float64 group: params, x (2, g, d), weights and ids (2, g, k)
    with every token's k experts distinct."""
    gen = torch.Generator().manual_seed(seed)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("olmoe-1b-7b"),
                              d_model=d, d_ff_expert=f, n_experts=e,
                              top_k=k)
    params = {
        name: torch.randn(shape, generator=gen, dtype=torch.float64)
        for name, shape in (("w_up", (e, d, f)), ("w_gate", (e, d, f)),
                            ("w_down", (e, f, d)))}
    x = torch.randn(2, g, d, generator=gen, dtype=torch.float64)
    ids = torch.stack([torch.randperm(e, generator=gen)[:k]
                       for _ in range(2 * g)]).reshape(2, g, k)
    w = torch.rand(2, g, k, generator=gen, dtype=torch.float64)
    return cfg, params, x, ids, w, cap


@pytest.mark.parametrize("k,cap", [(2, 8), (2, 4), (4, 8)],
                         ids=["k2", "k2_drops", "k4_drops"])
def test_moe_group_passes_gradcheck_in_float64(k, cap, monkeypatch):
    """The dispatch, the experts and the combine of one group, with the
    routing held fixed: analytic gradients of x, the router weights and
    every expert weight against finite differences.  The experts' SwiGLU
    runs in float64 here (the module's takes it in float32, whose rounding
    finite differences at 1e-6 would see)."""
    def experts64(params, buf, _cfg):
        xe = buf.transpose(0, 1).reshape(buf.shape[1], -1, buf.shape[3])
        h = torch.nn.functional.silu(torch.bmm(xe, params["w_gate"])) \
            * torch.bmm(xe, params["w_up"])
        y = torch.bmm(h, params["w_down"])
        return y.reshape(buf.shape[1], buf.shape[0], buf.shape[2],
                         -1).transpose(0, 1)

    monkeypatch.setattr(tmoe, "_experts", experts64)
    cfg, params, x, ids, w, cap = _tiny(k=k, cap=cap)
    if cap == 4:
        assert not bool(tmoe.dispatch(ids, cfg.n_experts, cap).keep.all())
    names = sorted(params)

    def fn(xx, ww, *weights):
        return tmoe._group(dict(zip(names, weights)), xx, ids, ww, cfg, cap)

    inputs = [t.clone().requires_grad_(True)
              for t in [x, w] + [params[n] for n in names]]
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-8)


def test_dispatch_backward_adds_in_ascending_expert_id():
    """A token's input gradient is the sum of its kept slots' gradients,
    added one after another in ascending expert id: bit for bit."""
    cfg, _params, x, ids, _w, cap = _tiny(k=4, e=8, cap=6, g=16, d=5)
    x, e = x.float(), cfg.n_experts
    plan = tmoe.dispatch(ids, e, cap)
    b, g, k = ids.shape
    by_expert = torch.argsort(ids, dim=-1)
    slot = plan.slot.gather(2, by_expert)
    keep = plan.keep.gather(2, by_expert)
    xt = x.clone().requires_grad_(True)
    buf = tmoe._Rows.apply(xt, plan.src.reshape(b, e * cap),
                           plan.filled.reshape(b, e * cap), slot, keep)
    grad = torch.randn(buf.shape, generator=torch.Generator().manual_seed(3))
    buf.backward(grad)
    want = torch.zeros_like(x)
    for bi in range(b):
        for t in range(g):
            acc = None
            for j in range(k):
                if keep[bi, t, j]:
                    row = grad[bi, slot[bi, t, j]]
                    acc = row if acc is None else acc + row
            if acc is not None:
                want[bi, t] = acc
    assert torch.equal(xt.grad, want)


def test_sentinel_slot_takes_no_gradient():
    """Dropped choices point at the sentinel slot E * cap.  With NaN in the
    output gradient of every dropped choice, the expert outputs' gradient
    stays finite and is zero at every slot no token fills; a token whose
    choices were all dropped takes no gradient from the dispatch, even with
    NaN at every slot no token fills."""
    cfg, _params, x, ids, _w, cap = _tiny(k=2, e=4, cap=2, g=16, d=3)
    e = cfg.n_experts
    plan = tmoe.dispatch(ids, e, cap)
    b, g, k = ids.shape
    n = e * cap
    assert not bool(plan.keep.all())
    by_expert = torch.argsort(ids, dim=-1)
    slot = plan.slot.gather(2, by_expert).reshape(b, g * k)
    keep = plan.keep.gather(2, by_expert).reshape(b, g * k)
    assert bool((slot[~keep] == n).all())
    base = torch.arange(g)[:, None] * k
    at = (base + torch.argsort(by_expert, dim=-1)).reshape(b, g * k)
    src, filled = plan.src.reshape(b, n), plan.filled.reshape(b, n)
    pair = at.gather(1, src * k + plan.choice.reshape(b, n))
    # combine
    y = torch.randn(b, n, 3, dtype=torch.float64, requires_grad=True)
    out = tmoe._Rows.apply(y, slot, keep, pair[..., None], filled[..., None])
    assert bool((out[~keep] == 0).all())
    grad = torch.ones_like(out)
    grad[~keep] = float("nan")
    out.backward(grad)
    assert bool(torch.isfinite(y.grad).all())
    assert bool((y.grad[~filled] == 0).all())
    assert bool((y.grad[filled] == 1).all())
    # dispatch
    xt = x.clone().requires_grad_(True)
    buf = tmoe._Rows.apply(xt, src, filled, slot.reshape(b, g, k),
                           keep.reshape(b, g, k))
    gbuf = torch.ones_like(buf)
    gbuf[~filled] = float("nan")
    buf.backward(gbuf)
    assert bool(torch.isfinite(xt.grad).all())
    kept = keep.reshape(b, g, k).sum(-1)
    assert bool((kept == 0).any())
    assert bool((xt.grad[kept == 0] == 0).all())
    assert torch.equal(xt.grad, kept[..., None].to(xt.dtype)
                       .expand_as(xt.grad))


class _FloatAccumulations(TorchDispatchMode):
    """Records every op that adds floats into a tensor at indices: the
    CUDA forms of these use atomics."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        target = args[0] if args else None
        floating = isinstance(target, torch.Tensor) and \
            target.dtype.is_floating_point
        accumulate = name.startswith(("scatter_add", "index_add",
                                      "scatter_reduce")) or (
            name.startswith(("index_put", "_index_put_impl", "put"))
            and bool(kwargs.get("accumulate",
                                args[3] if len(args) > 3 else False)))
        if floating and accumulate:
            self.seen.append(str(func))
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch,top_k", CASES, ids=CASE_IDS)
def test_moe_backward_adds_floats_at_no_index(arch, top_k):
    """No scatter_add, index_add or index_put(accumulate=True) on floats in
    the MoE FFN's backward, routing included, over groups recomputed
    under checkpoint and with choices dropped."""
    _jcfg, tcfg = _cfgs(arch, **_change(top_k, 0.5, 8))
    _jm, tm = _moe_params(_jcfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    x = torch.randn(2, 32, tcfg.d_model,
                    generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    y, aux = tmoe.moe_ffn(leaves, x, tcfg)
    loss = (y * y).sum() + aux
    mode = _FloatAccumulations()
    with mode:
        torch.autograd.grad(loss, [x, *leaves.values()])
    assert mode.seen == []
    # the recorder sees the forward's own gather backward where it runs
    probe = x.detach().clone().requires_grad_(True)
    with mode:
        probe.gather(1, torch.zeros(2, 1, tcfg.d_model,
                                    dtype=torch.int64)).sum().backward()
    assert mode.seen and "scatter_add" in mode.seen[0]
