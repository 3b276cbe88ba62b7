"""Port parity: the stub frontends (``repro_torch.models.frontends``) and
``prefix_embeds`` through the decoder, against the reference.

internvl2-26b (vlm) and musicgen-medium (audio) take precomputed
embeddings ahead of their tokens.  Weights are the reference's, carried
across with ``convert.lm_params_from_jax``; tokens and prefix embeddings
come from a numpy seed; fp32 smoke configs.  Tolerances: logits 1e-4, loss
1e-5, greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import frontends as jfront
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import frontends as tfront
from repro_torch.models import lm as tlm
from repro_torch.train import step as tstep

FRONTEND_ARCHS = ("internvl2-26b", "musicgen-medium")
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5


def _setup(arch, b, s, seed=0):
    jcfg, tcfg = jax_smoke(arch), tconfigs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jcfg.vocab, (b, s), dtype=np.int32)
    pre = (rng.standard_normal((b, jcfg.prefix_len, jcfg.d_model)) * 0.02
           ).astype(np.float32)
    return jcfg, tcfg, jp, tp, toks, pre


def _close(port, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", JAX_ARCH_NAMES)
def test_prefix_embed_shape_matches_reference(arch):
    for get_t, get_j in ((tconfigs.get_smoke_config, jax_smoke),
                         (tconfigs.get_config, jax_config)):
        assert tfront.prefix_embed_shape(get_t(arch), 3) == \
            jfront.prefix_embed_shape(get_j(arch), 3)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_synthetic_prefix_draws_float32_then_casts_then_scales(arch, dtype):
    cfg = tconfigs.get_config(arch)
    pe = tfront.synthetic_prefix(torch.Generator().manual_seed(5), cfg, 2,
                                 dtype=dtype)
    assert pe.shape == (2, cfg.prefix_len, cfg.d_model) and pe.dtype == dtype
    draw = torch.randn((2, cfg.prefix_len, cfg.d_model),
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(pe, draw.to(dtype) * 0.02)
    assert abs(float(pe.float().std()) / 0.02 - 1.0) < 0.05
    jpe = jfront.synthetic_prefix(jax.random.PRNGKey(0), jax_config(arch), 2)
    assert str(jpe.dtype) == "bfloat16" and tuple(jpe.shape) == \
        tuple(tfront.synthetic_prefix(torch.Generator(), cfg, 2).shape)


def test_synthetic_prefix_is_none_without_a_frontend():
    for arch in ("olmo-1b", "olmoe-1b-7b", "falcon-mamba-7b"):
        assert tfront.synthetic_prefix(
            torch.Generator(), tconfigs.get_smoke_config(arch), 2) is None
    cfg = dataclasses.replace(tconfigs.get_smoke_config("internvl2-26b"),
                              prefix_len=0)
    assert tfront.prefix_embed_shape(cfg, 2) is None


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_forward_with_prefix_matches_reference(arch):
    jcfg, tcfg, jp, tp, toks, pre = _setup(arch, 2, 12)
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, jnp.asarray(pre))
    out, aux = tlm.forward(tp, torch.from_numpy(toks).long(), tcfg,
                           torch.from_numpy(pre))
    assert out.shape == (2, jcfg.prefix_len + 12, tcfg.vocab_padded)
    assert float(aux) == 0.0
    _close(out[..., :tcfg.vocab], np.asarray(ref)[..., :tcfg.vocab])
    # the prefix changes every position's logits (it is attended to)
    plain, _ = tlm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert not torch.allclose(plain, out[:, jcfg.prefix_len:], atol=1e-3)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_with_prefix_then_decode_matches_reference(arch):
    jcfg, tcfg, jp, tp, toks, pre = _setup(arch, 2, 10, seed=2)
    seq = jcfg.prefix_len + 10
    gen = 4
    jl, jc = jlm.prefill_step(jp, jnp.asarray(toks), jcfg, max_seq=seq + gen,
                              prefix_embeds=jnp.asarray(pre))
    tl, tc = tlm.prefill_step(tp, torch.from_numpy(toks).long(), tcfg,
                              max_seq=seq + gen,
                              prefix_embeds=torch.from_numpy(pre))
    _close(tl[..., :tcfg.vocab], np.asarray(jl)[..., :tcfg.vocab])
    for i in range(gen):
        jt = jnp.argmax(jl[:, -1, :jcfg.vocab], axis=-1)[:, None]
        tt = tl[:, -1, :tcfg.vocab].argmax(-1, keepdim=True)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jlm.decode_step(jp, jc, jt.astype(jnp.int32),
                                 jnp.int32(seq + i), jcfg)
        tl, tc = tlm.decode_step(tp, tc, tt, seq + i, tcfg)
        _close(tl[..., :tcfg.vocab], np.asarray(jl)[..., :tcfg.vocab])


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_loss_with_prefix_matches_reference(arch):
    """The loss scores text positions only."""
    jcfg, tcfg, jp, tp, toks, pre = _setup(arch, 2, 12, seed=3)
    labs = np.roll(toks, -1, axis=1)
    jloss, jparts = jstep.loss_fn(jp, jnp.asarray(toks), jnp.asarray(labs),
                                  jcfg, jnp.asarray(pre))
    loss, parts = tstep.loss_fn(tp, torch.from_numpy(toks).long(),
                                torch.from_numpy(labs).long(), tcfg,
                                torch.from_numpy(pre))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(float(parts["ce"]) - float(jparts["ce"])) <= \
        LOSS_RTOL * abs(float(jparts["ce"]))


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_make_train_batch_carries_the_prefix(arch):
    cfg = tconfigs.get_smoke_config(arch)
    batch = tstep.make_train_batch(torch.Generator().manual_seed(0), cfg, 2,
                                   16)
    assert batch["tokens"].shape == (2, 16 - cfg.prefix_len)
    assert batch["labels"].shape == batch["tokens"].shape
    assert batch["prefix_embeds"].shape == (2, cfg.prefix_len, cfg.d_model)
    assert batch["prefix_embeds"].dtype == torch.bfloat16
    ref = jstep.make_train_batch(jax.random.PRNGKey(0), jax_smoke(arch), 2,
                                 16)
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: tuple(v.shape) for k, v in batch.items()}
    # a train step takes it: the loss is finite and the prefix is scored
    # nowhere
    loss, _parts, grads = tstep.loss_and_grads(
        tstep.as_trainable(tlm.init_params(torch.Generator().manual_seed(1),
                                           cfg, device="cpu")), batch, cfg)
    assert torch.isfinite(loss)
