"""Port parity: the Mamba mixer (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba``.

Weights are the reference's ``init_params`` carried across with
``convert.lm_params_from_jax``; activations come from a numpy seed; the
fp32 falcon-mamba smoke config.  The port's chunked doubling scan adds in
another order than the reference's associative scan: outputs within 1e-4
relative / 1e-5 absolute, the decode states within the same bounds.
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
from repro.models import mamba as jmamba
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba

RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4
ARCH = "falcon-mamba-7b"


def _cfgs(**change):
    return (dataclasses.replace(jax_smoke(ARCH), **change),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), **change))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    jm = jax.tree.map(lambda p: p[0], jp["layers"]["sub_0"]["mamba"])
    return jm, lm_params_from_jax(jax.tree.map(np.asarray, jm))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# -- declarations and init --------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_mamba_decls_match_reference(arch):
    for get_t, get_j in ((tconfigs.get_smoke_config, jax_smoke),
                         (tconfigs.get_config, jax_config)):
        td, jd = tmamba.mamba_decls(get_t(arch)), jmamba.mamba_decls(
            get_j(arch))
        assert sorted(td) == sorted(jd)
        for key in td:
            a, b = td[key], jd[key]
            assert (a.shape, a.axes, a.init, a.scale, a.dtype) == \
                (b.shape, b.axes, b.init, b.scale, b.dtype), key
    assert td["a_log"].dtype == td["dt_bias"].dtype == "float32"


def test_custom_inits_match_reference():
    """a_log is log(1..d_state) on every channel, bit for bit; dt_bias is
    the inverse softplus of a dt in [1e-3, 1e-1]."""
    jcfg, tcfg = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    ja = np.asarray(jp["layers"]["sub_0"]["mamba"]["a_log"])
    ta = tp["layers"]["sub_0"]["mamba"]["a_log"]
    assert ta.shape == ja.shape and ta.dtype == torch.float32
    np.testing.assert_array_equal(ta.numpy(), ja)
    dt = torch.nn.functional.softplus(tp["layers"]["sub_0"]["mamba"]
                                      ["dt_bias"].double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    # log-uniform: about half the channels below the geometric midpoint
    assert 0.3 < float((dt < 1e-2).double().mean()) < 0.7


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_bf16_model_keeps_a_log_and_dt_bias_float32(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype="bfloat16")
    tp = tlm.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    jp = jlm.init_params(jax.random.PRNGKey(1),
                         dataclasses.replace(jax_smoke(arch),
                                             dtype="bfloat16"))
    for i, (mixer, _ff) in enumerate(cfg.pattern):
        if mixer != "mamba":
            continue
        for key, leaf in tp["layers"][f"sub_{i}"]["mamba"].items():
            ref = jp["layers"][f"sub_{i}"]["mamba"][key]
            want = torch.float32 if key in ("a_log", "dt_bias") \
                else torch.bfloat16
            assert leaf.dtype == want, key
            assert str(ref.dtype) == str(want).replace("torch.", ""), key


# -- the block against the reference -----------------------------------------------


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ref = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = tmamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("length", [32, 13])
@pytest.mark.parametrize("return_state", [False, True],
                         ids=["out", "with_state"])
def test_mamba_block_matches_reference(chunk, length, return_state):
    jcfg, tcfg = _cfgs(ssm_chunk=chunk)
    jm, tm = _params(jcfg)
    x = _x(jcfg, 2, length, seed=4)
    ref = jmamba.mamba_block(jm, jnp.asarray(x), jcfg,
                             return_state=return_state)
    out = tmamba.mamba_block(tm, torch.from_numpy(x), tcfg,
                             return_state=return_state)
    if not return_state:
        assert out.shape == (2, length, tcfg.d_model)
        _close(out, ref)
        return
    assert out[1].shape == (2, tcfg.ssm_conv - 1, tcfg.d_inner)
    assert out[2].shape == (2, tcfg.d_inner, tcfg.ssm_state)
    assert out[2].dtype == torch.float32
    for port, r in zip(out, ref):
        _close(port, r)


def test_mamba_chunk_invariance():
    """The twin of tests/test_models.py::test_mamba_chunk_invariance."""
    _jcfg, cfg = _cfgs()
    _jm, sub = _params(_jcfg)
    x = torch.from_numpy(_x(cfg, 2, 32, seed=0))
    outs = {}
    for chunk in (4, 8, 32):
        c = dataclasses.replace(cfg, ssm_chunk=chunk)
        outs[chunk] = tmamba.mamba_block(sub, x, c).numpy()
    np.testing.assert_allclose(outs[4], outs[32], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[8], outs[32], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("length", [1, 13, 32])
def test_scan_in_place_without_autograd_gives_the_same_bits(length):
    """Without autograd the doubling scan updates its tails in place; with
    it, each pass makes new tensors.  Both do the same multiplies and
    adds: the outputs and states are equal bit for bit."""
    _jcfg, cfg = _cfgs()
    _jm, sub = _params(_jcfg)
    x = torch.from_numpy(_x(cfg, 2, length, seed=3))
    with torch.no_grad():
        fast = tmamba.mamba_block(sub, x, cfg, return_state=True)
    with torch.enable_grad():
        xg = x.clone().requires_grad_(True)
        slow = tmamba.mamba_block(sub, xg, cfg, return_state=True)
    for a, b in zip(fast, slow):
        assert torch.equal(a, b.detach())


def test_mamba_nondivisible_length():
    """The twin of tests/test_models.py::test_mamba_nondivisible_length."""
    _jcfg, cfg = _cfgs()
    _jm, sub = _params(_jcfg)
    x = torch.from_numpy(_x(cfg, 1, 13, seed=0))   # 13 % 8 != 0
    y = tmamba.mamba_block(sub, x, cfg)
    assert y.shape == (1, 13, cfg.d_model)
    assert torch.isfinite(y).all()


def test_mamba_causality():
    """The twin of tests/test_models.py::test_mamba_causality: the output
    at position t does not depend on inputs after t."""
    _jcfg, cfg = _cfgs()
    _jm, sub = _params(_jcfg)
    x1 = torch.from_numpy(_x(cfg, 1, 16, seed=0))
    x2 = x1.clone()
    x2[:, 10:] = torch.from_numpy(_x(cfg, 1, 6, seed=9))
    y1 = tmamba.mamba_block(sub, x1, cfg).numpy()
    y2 = tmamba.mamba_block(sub, x2, cfg).numpy()
    np.testing.assert_allclose(y1[:, :10], y2[:, :10], rtol=1e-5, atol=1e-6)
    assert not np.allclose(y1[:, 10:], y2[:, 10:])


@pytest.mark.parametrize("prompt", [10, 2])
def test_decode_chained_after_prefill_matches_reference(prompt):
    """Prefill states, then decode steps token by token: every step's
    output and states against the reference's, and against the port's own
    block over the whole sequence.

    A 2-token prompt is shorter than the conv's K - 1 = 3 inputs: the port
    keeps zeros before the prompt, the state the causal conv reads; the
    reference's tail slice (``mamba.py:173``) then gives 1 row, which its
    decode cannot take (ROADMAP.md section 3), so the reference's state
    is built here from its own conv inputs."""
    jcfg, tcfg = _cfgs()
    jm, tm = _params(jcfg)
    k1 = jcfg.ssm_conv - 1
    x = _x(jcfg, 2, prompt + 5, seed=6)
    full = tmamba.mamba_block(tm, torch.from_numpy(x), tcfg)
    _y, tconv, tssm = tmamba.mamba_block(tm, torch.from_numpy(x[:, :prompt]),
                                         tcfg, return_state=True)
    _jy, jconv, jssm = jmamba.mamba_block(jm, jnp.asarray(x[:, :prompt]),
                                          jcfg, return_state=True)
    if prompt < k1:
        assert jconv.shape[1] != k1
        xs = jnp.einsum("bld,de->ble", jnp.asarray(x[:, :prompt]),
                        jm["in_proj"])[..., :jcfg.d_inner]
        jconv = jnp.concatenate(
            [jnp.zeros((2, k1 - prompt, jcfg.d_inner)), xs], axis=1)
    assert tconv.shape == (2, k1, tcfg.d_inner)
    _close(tconv, jconv)
    _close(tssm, jssm)
    for t in range(prompt, prompt + 5):
        xt = x[:, t:t + 1]
        jy, jconv, jssm = jmamba.mamba_decode_step(jm, jnp.asarray(xt), jcfg,
                                                   jconv, jssm)
        ty, tconv, tssm = tmamba.mamba_decode_step(tm, torch.from_numpy(xt),
                                                   tcfg, tconv, tssm)
        assert tssm.dtype == torch.float32
        _close(ty, jy)
        _close(tconv, jconv)
        _close(tssm, jssm)
        _close(ty[:, 0], full[:, t])


def test_mamba_gradients_match_reference():
    jcfg, tcfg = _cfgs(ssm_chunk=4)
    jm, tm = _params(jcfg)
    x = _x(jcfg, 2, 13, seed=7)
    probe = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jmamba.mamba_block(p, xx, jcfg) * probe)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(tmamba.mamba_block(leaves, xt, tcfg)
              * torch.from_numpy(probe)).backward()
    for key, tv in leaves.items():
        ref = np.asarray(jg[key])
        scale = float(np.abs(ref).max())
        assert scale > 0, key
        assert float(np.abs(tv.grad.numpy() - ref).max()) <= \
            GRAD_TOL * scale, key
    ref = np.asarray(jgx)
    assert float(np.abs(xt.grad.numpy() - ref).max()) <= \
        GRAD_TOL * float(np.abs(ref).max())
