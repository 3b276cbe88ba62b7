"""Port parity: the LM layers and the decoder of every arch family against
the reference.

Weights are the reference's ``init_params`` carried across with
``convert.lm_params_from_jax``; tokens and activations come from a numpy
seed.  On the CPU the port's prefill attention takes the flash kernel's
plain version; ``chip_smoke.py`` holds the kernel against it on the card.
fp32 tolerances: 1e-5 for a layer, 1e-4 for logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.frontends import synthetic_prefix as jax_prefix
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

DENSE = ("olmo-1b", "glm4-9b", "minicpm-2b", "phi3-mini-3.8b")
NEW = ("internvl2-26b", "musicgen-medium", "olmoe-1b-7b",
       "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b", "jamba-v0.1-52b")
ALL = tuple(JAX_ARCH_NAMES)
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4


def _params(cfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _prefix(cfg, b, seed=3):
    """The reference's synthetic prefix in fp32, or None without one."""
    pe = jax_prefix(jax.random.PRNGKey(seed), cfg, b, jnp.float32)
    return None if pe is None else np.asarray(pe)


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL)
def test_configs_are_copies(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(tconfigs.get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke(arch))


def test_registry_lists_every_reference_arch():
    assert tconfigs.ARCH_NAMES == JAX_ARCH_NAMES
    assert not hasattr(tconfigs, "NOT_PORTED")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_smoke_config("no-such-arch")


# -- params --------------------------------------------------------------------


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_matches_reference(arch):
    cfg = tconfigs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(3)
    tp = tlm.init_params(gen, cfg, device="cpu")
    jp = jlm.init_params(jax.random.PRNGKey(0), jax_smoke(arch))
    jt = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    assert _shapes(tp) == _shapes(jt)
    again = tlm.init_params(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(tp), jax.tree.leaves(again)))
    # the same init rule per leaf (fan-in, normal 0.02, ones, zeros): the
    # spread of each random leaf is the reference's
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jt)):
        if float(b.std()) == 0.0:
            assert torch.equal(a, b)
        else:
            assert abs(float(a.std()) / float(b.std()) - 1.0) < 0.1


def _named(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", NEW)
def test_init_params_of_the_new_families_match_reference(arch):
    """The six MoE, Mamba, hybrid and frontend archs: the same tree of
    shapes and dtypes, the same init rule per leaf (the expert stacks'
    fan-in, the router's 0.1, a_log bit for bit, dt_bias in its range)."""
    cfg = tconfigs.get_smoke_config(arch)
    tp = tlm.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    jt = lm_params_from_jax(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(0), jax_smoke(arch))))
    assert _shapes(tp) == _shapes(jt)
    for (name, a), (_n, b) in zip(_named(tp), _named(jt)):
        if name.endswith("a_log") or float(b.std()) == 0.0:
            assert torch.equal(a, b), name
        elif name.endswith("dt_bias"):
            dt = torch.nn.functional.softplus(a.double())
            assert 1e-3 * (1 - 1e-5) <= float(dt.min()) and \
                float(dt.max()) <= 1e-1 * (1 + 1e-5), name
        else:
            assert abs(float(a.std()) / float(b.std()) - 1.0) < 0.1, name


def test_init_draws_a_leaf_larger_than_a_piece_in_pieces(monkeypatch):
    """Leaves of more than ``declare.DRAW_CHUNK`` elements (a full-width
    expert stack) are drawn piece by piece: the same shapes, dtypes and
    spread, the same values from the same seed."""
    from repro_torch.models import declare

    cfg = dataclasses.replace(tconfigs.get_smoke_config("olmoe-1b-7b"),
                              dtype="bfloat16")
    whole = tlm.init_params(torch.Generator().manual_seed(4), cfg,
                            device="cpu")
    monkeypatch.setattr(declare, "DRAW_CHUNK", 1000)
    pieces = tlm.init_params(torch.Generator().manual_seed(4), cfg,
                             device="cpu")
    again = tlm.init_params(torch.Generator().manual_seed(4), cfg,
                            device="cpu")
    assert _shapes(pieces) == _shapes(whole)
    split = 0
    for (name, a), (_n, b), (_m, c) in zip(_named(pieces), _named(whole),
                                          _named(again)):
        assert torch.equal(a, c), name
        if a.numel() > 1000 and float(b.float().std()) > 0:
            split += 1
            assert not torch.equal(a, b), name
            assert abs(float(a.float().std()) / float(b.float().std())
                       - 1.0) < 0.1, name
    assert split >= 4   # the expert stacks and the embedding at least


@pytest.mark.parametrize("arch", ALL)
def test_full_width_declarations_match_reference(arch):
    """Every leaf's shape and dtype at the published width, from the
    declarations alone (no weights drawn)."""
    tcfg = tconfigs.get_config(arch)
    tdecl = tlm.model_decls(tcfg)
    jabs = jlm.abstract_params(jax_get_config(arch))
    dt = tlm.model_dtype(tcfg)
    tl, jl = list(_named(tdecl)), list(_named(jabs))
    assert [n for n, _ in tl] == [n for n, _ in jl]
    for (name, t), (_n, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), name
        assert str(t.resolve_dtype(dt)).replace("torch.", "") == \
            str(j.dtype), name


@pytest.mark.parametrize("arch", ALL)
def test_param_axes_match_reference(arch):
    assert tlm.param_axes(tconfigs.get_config(arch)) == \
        jlm.param_axes(jax_get_config(arch))


def test_full_width_olmo_declarations_match_reference():
    cfg = tconfigs.get_config("olmo-1b")
    tdecl = tlm.model_decls(cfg)
    jabs = jlm.abstract_params(jax_get_config("olmo-1b"))

    def shapes(t, j):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j)
            for k in t:
                shapes(t[k], j[k])
        else:
            assert tuple(t.shape) == tuple(j.shape)

    shapes(tdecl, jabs)
    assert tdecl["embed"].shape == (50432, 2048)
    assert "lm_head" not in tdecl   # tied embeddings


def test_lm_params_from_jax_keeps_float32_leaves_in_a_bf16_tree():
    """A bf16 jamba tree: a_log and dt_bias stay float32, the (E, d, f)
    expert stacks bf16, every value bit for bit."""
    cfg = dataclasses.replace(jax_smoke("jamba-v0.1-52b"), dtype="bfloat16")
    jp = jax.tree.map(np.asarray,
                      jlm.init_params(jax.random.PRNGKey(2), cfg))
    tp = lm_params_from_jax(jp)
    mamba = tp["layers"]["sub_0"]["mamba"]
    assert mamba["a_log"].dtype == mamba["dt_bias"].dtype == torch.float32
    assert mamba["in_proj"].dtype == torch.bfloat16
    moe = tp["layers"]["sub_1"]["moe"]
    assert moe["w_up"].dtype == torch.bfloat16
    assert tuple(moe["w_up"].shape) == (cfg.n_groups, cfg.n_experts,
                                        cfg.d_model, cfg.d_ff_expert)
    for (name, a), (_n, b) in zip(_named(tp), _named(jp)):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), name
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_lm_params_from_jax_keeps_bfloat16():
    cfg = jax_smoke("olmo-1b")
    jp = jlm.init_params(jax.random.PRNGKey(1),
                         dataclasses.replace(cfg, dtype="bfloat16"))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    a = np.asarray(jp["layers"]["sub_0"]["mlp"]["w_up"], np.float32)
    b = tp["layers"]["sub_0"]["mlp"]["w_up"]
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.float().numpy(), a)


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm_matches_reference(norm):
    cfg = dataclasses.replace(jax_smoke("olmo-1b"), norm=norm)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    params = {}
    if norm != "nonparam_ln":
        params["scale"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    if norm == "layernorm":
        params["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    ref = jlayers.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), cfg)
    out = tlayers.apply_norm({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    _close(out, ref, LAYER_TOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "phi3-mini-3.8b"])
def test_apply_rope_matches_reference(arch):
    cfg = jax_smoke(arch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 3, cfg.d_head)).astype(np.float32)
    pos = np.arange(3, 12, dtype=np.int32)
    jc, js = jlayers.rope_freqs(cfg, jnp.asarray(pos))
    tc, ts = tlayers.rope_freqs(cfg, _t(pos))
    _close(tc, jc, LAYER_TOL)
    _close(ts, js, LAYER_TOL)
    _close(tlayers.apply_rope(_t(x), tc, ts),
           jlayers.apply_rope(jnp.asarray(x), jc, js), LAYER_TOL)


@pytest.mark.parametrize("arch", ["minicpm-2b", "glm4-9b", "phi3-mini-3.8b"])
def test_attention_matches_reference(arch):
    """minicpm-2b pads 6 heads to 8: the padded heads are masked."""
    cfg = jax_smoke(arch)
    jp, tp = _params(cfg)
    ja = jax.tree.map(lambda p: p[0], jp["layers"]["sub_0"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["sub_0"]["attn"].items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    ref = jlayers.attention(ja, jnp.asarray(x), cfg, jnp.asarray(pos))
    out = tlayers.attention(ta, _t(x), tconfigs.get_smoke_config(arch),
                            _t(pos))
    _close(out, ref, LAYER_TOL)


def test_attention_decode_matches_reference():
    cfg = jax_smoke("minicpm-2b")
    jp, tp = _params(cfg)
    ja = jax.tree.map(lambda p: p[0], jp["layers"]["sub_0"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["sub_0"]["attn"].items()}
    rng = np.random.default_rng(4)
    shape = (2, 8, cfg.n_kv_heads_padded, cfg.d_head)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jk, jv = jlayers.attention_decode(ja, jnp.asarray(x), cfg,
                                          jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.int32(5))
    ty, tk, tv = tlayers.attention_decode(ta, _t(x), cfg, _t(kc), _t(vc), 5)
    _close(ty, jy, LAYER_TOL)
    _close(tk, jk, LAYER_TOL)
    _close(tv, jv, LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    cfg = dataclasses.replace(jax_smoke("phi3-mini-3.8b"), act=act)
    decls = jlayers.mlp_decls(cfg)
    rng = np.random.default_rng(9)
    params = {k: (rng.standard_normal(d.shape) / d.shape[0] ** 0.5
                  ).astype(np.float32) for k, d in decls.items()}
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    ref = jlayers.mlp({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), cfg)
    out = tlayers.mlp({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    _close(out, ref, LAYER_TOL)


# -- the dense decoder ---------------------------------------------------------


@pytest.mark.parametrize("arch", ALL)
def test_forward_matches_reference(arch):
    """Every arch; the two stub-frontend archs with their prefix ahead of
    the tokens; the MoE aux loss within 1e-6 (0 elsewhere)."""
    cfg = jax_smoke(arch)
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, 12, seed=1)
    pe = _prefix(cfg, 2)
    ref, jaux = jlm.forward(jp, jnp.asarray(toks), cfg,
                            None if pe is None else jnp.asarray(pe))
    out, aux = tlm.forward(tp, _t(toks).long(), cfg,
                           None if pe is None else _t(pe))
    seq = 12 + (0 if pe is None else cfg.prefix_len)
    assert out.shape == (2, seq, cfg.vocab_padded)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0.0) == (cfg.n_experts > 0)
    _close(out[..., :cfg.vocab], np.asarray(ref)[..., :cfg.vocab], LOGIT_TOL)
    if cfg.vocab_padded != cfg.vocab:
        assert float(out[..., cfg.vocab:].max()) < -1e20


def _serve_both(cfg, prompt_len, gen, seed):
    """The reference's and the port's prefill + greedy decode on the same
    weights and prompts (and prefix, for a stub frontend); returns both
    logit streams and token streams."""
    jp, tp = _params(cfg, seed)
    toks = _tokens(cfg, 2, prompt_len, seed)
    pe = _prefix(cfg, 2, seed)
    if pe is not None:
        prompt_len += cfg.prefix_len
    max_seq = prompt_len + gen
    jl, jc = jlm.prefill_step(jp, jnp.asarray(toks), cfg, max_seq=max_seq,
                              prefix_embeds=None if pe is None
                              else jnp.asarray(pe))
    tl, tc = tlm.prefill_step(tp, _t(toks).long(), cfg, max_seq=max_seq,
                              prefix_embeds=None if pe is None else _t(pe))
    jlogits, tlogits, jtoks, ttoks = [jl], [tl], [], []
    for i in range(gen):
        jt = jnp.argmax(jl[:, -1, :cfg.vocab], axis=-1)[:, None]
        tt = tl[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
        jl, jc = jlm.decode_step(jp, jc, jt.astype(jnp.int32),
                                 jnp.int32(prompt_len + i), cfg)
        tl, tc = tlm.decode_step(tp, tc, tt, prompt_len + i, cfg)
        jlogits.append(jl)
        tlogits.append(tl)
    return jlogits, tlogits, jtoks, ttoks


@pytest.mark.parametrize("arch,attn_chunk,prompt_len", [
    ("olmo-1b", None, 12),
    ("glm4-9b", None, 12),
    # a 32-token prompt above attn_chunk=8: the reference goes through its
    # query-chunked _sdpa_chunked, the port through the same kernel
    ("olmo-1b", 8, 32),
    ("glm4-9b", 8, 32),
    *[(arch, None, 12) for arch in NEW],
    # MoE prefill past one dispatch group (moe_chunk 1024 in the smoke
    # configs): a 24-token prompt in groups of 8
    ("olmoe-1b-7b", "moe_chunk", 24),
    ("jamba-v0.1-52b", "moe_chunk", 24),
])
def test_prefill_and_decode_match_reference(arch, attn_chunk, prompt_len):
    cfg = jax_smoke(arch)
    if attn_chunk == "moe_chunk":
        cfg = dataclasses.replace(cfg, moe_chunk=8)
    elif attn_chunk is not None:
        cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk)
    jlogits, tlogits, jtoks, ttoks = _serve_both(cfg, prompt_len, gen=5,
                                                 seed=7)
    for jl, tl in zip(jlogits, tlogits):
        assert tl.shape == (2, 1, cfg.vocab_padded)
        _close(tl[..., :cfg.vocab], np.asarray(jl)[..., :cfg.vocab],
               LOGIT_TOL)
    for jt, tt in zip(jtoks, ttoks):
        np.testing.assert_array_equal(tt, jt)


def test_minicpm_prefill_matches_reference_forward():
    """36 heads padded to 48 at full width; 6 padded to 8 in the smoke
    config.  The port's prefill masks the padded heads, as the reference's
    forward and decode do."""
    cfg = jax_smoke("minicpm-2b")
    assert cfg.n_heads_padded != cfg.n_heads
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, 10, seed=3)
    full, _ = jlm.forward(jp, jnp.asarray(toks), cfg)
    tl, _ = tlm.prefill_step(tp, _t(toks).long(), cfg, max_seq=14)
    _close(tl[:, 0, :cfg.vocab], np.asarray(full)[:, -1, :cfg.vocab],
           LOGIT_TOL)


def test_reference_prefill_leaves_out_the_head_mask():
    """Documents a fault of the reference (ROADMAP.md section 3): its
    ``lm.prefill_step`` multiplies the attention output by ``wo`` without
    ``_head_mask``, so for an arch with padded heads its prefill logits are
    not its forward logits.  The port follows the forward."""
    cfg = jax_smoke("minicpm-2b")
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, 10, seed=3)
    jl, _ = jlm.prefill_step(jp, jnp.asarray(toks), cfg, max_seq=14)
    tl, _ = tlm.prefill_step(tp, _t(toks).long(), cfg, max_seq=14)
    gap = np.abs(tl[:, 0, :cfg.vocab].numpy()
                 - np.asarray(jl)[:, 0, :cfg.vocab]).max()
    assert gap > 100 * LOGIT_TOL, gap


@pytest.mark.parametrize("arch", ALL)
def test_prefill_then_decode_matches_forward(arch):
    """The port's counterpart of tests/test_models.py's prefill-then-decode
    check, on every smoke config with the reference's changes (no prefix,
    capacity 64 so the forward drops no MoE choice)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), prefix_len=0,
                              frontend="none", capacity_factor=64.0)
    tp = tlm.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    toks = _t(_tokens(cfg, 2, 16, seed=2)).long()
    full, _ = tlm.forward(tp, toks, cfg)
    logits, cache = tlm.prefill_step(tp, toks[:, :10], cfg, max_seq=16)
    _close(logits[:, 0], full[:, 9], LOGIT_TOL)
    for pos in range(10, 16):
        logits, cache = tlm.decode_step(tp, cache, toks[:, pos:pos + 1], pos,
                                        cfg)
        _close(logits[:, 0], full[:, pos], LOGIT_TOL)


@pytest.mark.parametrize(
    "arch", ["glm4-9b", "olmoe-1b-7b", "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_decode_matches_forward(arch):
    """The twin of tests/test_models.py::test_decode_matches_forward: token
    by token from an empty cache, at the reference's tolerance, and against
    the reference's forward at the logits' tolerance."""
    jcfg = dataclasses.replace(jax_smoke(arch), prefix_len=0,
                               frontend="none", capacity_factor=64.0)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), prefix_len=0,
                              frontend="none", capacity_factor=64.0)
    jp, tp = _params(jcfg)
    toks = _t(_tokens(cfg, 2, 12, seed=1)).long()
    full, _ = tlm.forward(tp, toks, cfg)
    cache = tlm.init_decode_cache(cfg, 2, 12, device="cpu")
    outs = []
    for pos in range(12):
        lg, cache = tlm.decode_step(tp, cache, toks[:, pos:pos + 1], pos, cfg)
        outs.append(lg[:, 0])
    inc = torch.stack(outs, dim=1)
    np.testing.assert_allclose(full.numpy(), inc.numpy(), rtol=1e-2,
                               atol=1e-2)
    ref, _ = jlm.forward(jp, jnp.asarray(toks.numpy()), jcfg)
    _close(inc[..., :cfg.vocab], np.asarray(ref)[..., :cfg.vocab], LOGIT_TOL)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_decode_cache_keeps_the_ssm_state_float32(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype="bfloat16")
    cache = tlm.init_decode_cache(cfg, 2, 8, device="cpu")
    tp = tlm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 5),
                         generator=torch.Generator().manual_seed(1))
    _logits, cache = tlm.prefill_step(tp, toks, cfg, max_seq=8)
    _logits, cache = tlm.decode_step(tp, cache, toks[:, :1], 5, cfg)
    for i, (mixer, _ff) in enumerate(cfg.pattern):
        sc = cache[f"sub_{i}"]
        if mixer == "mamba":
            assert sc["ssm"].dtype == torch.float32
            assert sc["conv"].dtype == torch.bfloat16
            assert tuple(sc["ssm"].shape) == (cfg.n_groups, 2, cfg.d_inner,
                                              cfg.ssm_state)
            assert float(sc["ssm"].abs().max()) > 0
        else:
            assert sc["k"].dtype == torch.bfloat16
