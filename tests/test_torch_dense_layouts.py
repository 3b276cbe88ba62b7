"""Port parity at the published head layouts of the three dense archs that
phase 3e and 3f of ``chip_smoke.py`` serve and train on the card, at narrow
widths:

- minicpm-2b: 36 MHA heads padded to 48 (``head_pad_multiple`` 16, its KV
  heads with them; the 12 padded heads masked), tied embeddings;
- phi3-mini-3.8b: heads of 96 (the plain attention runs at D 96, the width
  the tensor-core kernel takes on the card);
- glm4-9b: 32 query heads on 2 KV heads (GQA 16:1).

Each against the reference: ``forward`` logits; the prefill and each
greedy decode step after it, against the reference's ``forward`` over the
same tokens (the reference's own ``prefill_step`` leaves out the head mask,
ROADMAP queue 3); the training loss and its gradients.  Weights are the
reference's ``init_params`` carried across by ``convert.lm_params_from_jax``;
tokens come from a numpy seed.  fp32; logits within 1e-4, the loss within
1e-5 relative, every gradient leaf within 1e-4 of its largest |g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.train import step as tstep
from repro_torch.tree import tree_leaves

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4

# the published head layout on each smoke config's narrow widths
LAYOUTS = {
    "minicpm-2b": dict(n_heads=36, n_kv_heads=36, d_head=8,
                       head_pad_multiple=16),
    "phi3-mini-3.8b": dict(n_heads=2, n_kv_heads=2, d_head=96,
                           head_pad_multiple=2),
    "glm4-9b": dict(n_heads=32, n_kv_heads=2, d_head=8,
                    head_pad_multiple=16),
}
ARCHS = tuple(LAYOUTS)


def _cfgs(arch, **change):
    change = dict(LAYOUTS[arch], **change)
    return (dataclasses.replace(jax_smoke(arch), **change),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **change))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _close(port, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_layouts_are_the_published_ones():
    """The cases' head counts are the published configs' (widths cut)."""
    minicpm, phi3, glm4 = (_cfgs(a)[1] for a in ARCHS)
    for cfg, arch in ((minicpm, "minicpm-2b"), (glm4, "glm4-9b")):
        full = tconfigs.get_config(arch)
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_pad_multiple) == \
            (full.n_heads, full.n_kv_heads, full.head_pad_multiple)
        assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == \
            (full.n_heads_padded, full.n_kv_heads_padded)
    assert (minicpm.n_heads_padded, minicpm.n_kv_heads_padded) == (48, 48)
    assert minicpm.tie_embeddings
    assert (glm4.n_heads_padded, glm4.n_kv_heads_padded) == (32, 2)
    assert phi3.d_head == tconfigs.get_config("phi3-mini-3.8b").d_head == 96
    assert phi3.n_heads_padded == phi3.n_heads


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 12, seed=1)
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    out, aux = tlm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert out.shape == (2, 12, tcfg.vocab_padded) and float(aux) == 0.0
    _close(out[..., :tcfg.vocab], np.asarray(ref)[..., :jcfg.vocab])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_forward(arch):
    """The prefill's last logits and 5 greedy decode steps after it, each
    against the reference's forward over the prompt and the tokens fed so
    far (the port's greedy tokens, fed to both)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=2)
    prompt, gen = 10, 5
    toks = _tokens(jcfg, 2, prompt, seed=3)
    seq = torch.from_numpy(toks).long()
    logits, cache = tlm.prefill_step(tp, seq, tcfg, max_seq=prompt + gen)
    for i in range(gen + 1):
        ref, _ = jlm.forward(jp, jnp.asarray(seq.numpy().astype(np.int32)),
                             jcfg)
        assert logits.shape == (2, 1, tcfg.vocab_padded)
        _close(logits[:, -1, :tcfg.vocab],
               np.asarray(ref)[:, -1, :jcfg.vocab])
        if i == gen:
            break
        tok = logits[:, -1, :tcfg.vocab].argmax(-1, keepdim=True)
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = tlm.decode_step(tp, cache, tok, prompt + i, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loss_chunk", [0, 2], ids=["ce", "chunked_ce"])
def test_loss_and_grads_match_reference(arch, loss_chunk):
    jcfg, tcfg = _cfgs(arch, loss_chunk=loss_chunk)
    jp, tp = _params(jcfg, seed=4)
    tp = tstep.as_trainable(tp)
    toks = _tokens(jcfg, 4, 16, seed=5)
    labs = np.roll(toks, -1, axis=1)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, toks, labs, jcfg), has_aux=True))(jp)
    loss, _parts, grads = tstep.loss_and_grads(
        tp, {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()}, tcfg)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        LOSS_RTOL * abs(float(jloss))
    pl, rl = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0
        assert float(np.abs(a.numpy() - b).max()) <= GRAD_TOL * scale
