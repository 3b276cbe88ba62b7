"""Port parity: the training step (``repro_torch.train``) against the
reference's ``repro.train.step``.

Weights and optimizer state come from the reference
(``init_params`` / ``init_train_state``) through ``convert``; tokens from a
numpy seed.  Every dense smoke arch: olmo-1b, minicpm-2b (padded heads),
glm4-9b (GQA) and phi3-mini; and the six others: the MoE archs with their
load-balance loss in the total, the Mamba and hybrid archs, the two
stub-frontend archs with prefix embeddings ahead of the scored tokens.  Tolerances: loss 1e-5 relative and every
gradient leaf within 1e-4 of its largest |g|; three train steps' loss and
grad_norm within 1e-4 relative, lr and step exact.  The training attention
route (``layers._sdpa``) and the flash wrapper's are checked apart.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.schedule import make_schedule as jax_schedule
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.kernels.attention import ops as aops
from repro_torch.launch.train import restore_train_state
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import make_schedule
from repro_torch.train import step as tstep
from repro_torch.tree import tree_leaves

DENSE = ("olmo-1b", "minicpm-2b", "glm4-9b", "phi3-mini-3.8b")
NEW = ("internvl2-26b", "musicgen-medium", "olmoe-1b-7b",
       "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b", "jamba-v0.1-52b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-4
B, S = 4, 16


def _cfgs(arch, **change):
    return (dataclasses.replace(jax_smoke(arch), **change),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **change))


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    labs = np.roll(toks, -1, axis=1)
    return ({"tokens": toks, "labels": labs},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()})


def _with_prefix(jcfg, jb, tb, seed):
    """Add prefix embeddings to both batches for a stub-frontend arch."""
    if not jcfg.prefix_len:
        return jb, tb
    pe = (np.random.default_rng(seed).standard_normal(
        (B, jcfg.prefix_len, jcfg.d_model)) * 0.02).astype(np.float32)
    return (dict(jb, prefix_embeds=pe),
            dict(tb, prefix_embeds=torch.from_numpy(pe)))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = tstep.as_trainable(lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jp, tp


def _grads_close(port, ref):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0
        assert float(np.abs(a.numpy() - b).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("loss_chunk", [0, 2], ids=["ce", "chunked_ce"])
@pytest.mark.parametrize("attn_chunk", [0, 8], ids=["sdpa", "sdpa_chunked"])
def test_loss_and_grads_match_reference(arch, loss_chunk, attn_chunk):
    jcfg, tcfg = _cfgs(arch, loss_chunk=loss_chunk, attn_chunk=attn_chunk)
    jp, tp = _params(jcfg)
    jb, tb = _batch(jcfg, seed=1)
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jb["tokens"], jb["labels"], jcfg),
        has_aux=True))(jp)
    loss, parts, grads = tstep.loss_and_grads(tp, tb, tcfg)
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(float(parts["ce"].detach()) - float(jparts["ce"])) <= \
        LOSS_RTOL * abs(float(jparts["ce"]))
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    _grads_close(grads, jg)


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("loss_chunk", [0, 2], ids=["ce", "chunked_ce"])
def test_loss_and_grads_of_the_new_families_match_reference(arch,
                                                            loss_chunk):
    """The total loss (CE plus the MoE aux term), its parts and every
    gradient leaf; capacity drops in the forward as in the reference."""
    jcfg, tcfg = _cfgs(arch, loss_chunk=loss_chunk)
    jp, tp = _params(jcfg)
    jb, tb = _with_prefix(jcfg, *_batch(jcfg, seed=1), seed=2)
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jb["tokens"], jb["labels"], jcfg,
                                jb.get("prefix_embeds")),
        has_aux=True))(jp)
    loss, parts, grads = tstep.loss_and_grads(tp, tb, tcfg)
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(float(parts["ce"].detach()) - float(jparts["ce"])) <= \
        LOSS_RTOL * abs(float(jparts["ce"]))
    assert abs(float(parts["aux"].detach()) - float(jparts["aux"])) <= 1e-6
    assert (float(parts["aux"].detach()) > 0) == (tcfg.n_experts > 0)
    _grads_close(grads, jg)


@pytest.mark.parametrize("arch", DENSE + ("olmoe-1b-7b", "jamba-v0.1-52b"))
def test_remat_modes_give_the_same_gradient_bits(arch):
    _jcfg, tcfg = _cfgs(arch, loss_chunk=2, attn_chunk=8)
    _jp, tp = _params(_jcfg)
    _jb, tb = _batch(_jcfg, seed=2)
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, _parts, grads = tstep.loss_and_grads(tp, tb, cfg)
        out[remat] = (loss, tree_leaves(grads))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["none"][1]))


def test_unknown_remat_raises():
    _jcfg, tcfg = _cfgs("olmo-1b", remat="sometimes")
    _jp, tp = _params(_jcfg)
    _jb, tb = _batch(_jcfg, seed=0)
    with pytest.raises(ValueError, match="remat"):
        tstep.loss_and_grads(tp, tb, tcfg)


@pytest.mark.parametrize("arch", DENSE + ("internvl2-26b", "olmoe-1b-7b",
                                          "jamba-v0.1-52b"))
def test_train_steps_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    js = jstep.init_train_state(jax.random.PRNGKey(0), jcfg)
    ts = train_state_from_jax(
        dataclasses.asdict(jax.tree.map(np.asarray, js)))
    jf = jax.jit(jstep.make_train_step(jcfg, JaxAdamW(lr=1e-3),
                                       jax_schedule("wsd", 3)))
    tf = tstep.make_train_step(tcfg, AdamWConfig(lr=1e-3),
                               make_schedule("wsd", 3))
    for i in range(3):
        jb, tb = _with_prefix(jcfg, *_batch(jcfg, seed=10 + i), seed=20 + i)
        js, jm = jf(js, jb)
        ts, tm = tf(ts, tb)
        for key in ("loss", "grad_norm", "ce", "aux"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                STEP_RTOL * abs(float(jm[key])), (i, key)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(ts.step) == int(js.step) == i + 1
        assert int(ts.opt["count"]) == int(js.opt["count"])


def test_train_state_from_jax_carries_every_field():
    jcfg = dataclasses.replace(jax_smoke("olmo-1b"), dtype="bfloat16")
    js = jstep.init_train_state(jax.random.PRNGKey(1), jcfg)
    tree = dataclasses.asdict(jax.tree.map(np.asarray, js))
    ts = train_state_from_jax(tree)
    assert set(ts.opt) == {"mu", "nu", "count", "master"}
    for port, ref in ((ts.params, tree["params"]),
                      (ts.opt["mu"], tree["opt"]["mu"]),
                      (ts.opt["master"], tree["opt"]["master"])):
        for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
            assert a.dtype == (torch.bfloat16 if b.dtype.name == "bfloat16"
                               else torch.float32)
            assert np.array_equal(a.detach().float().numpy(),
                                  np.asarray(b, np.float32))
    assert all(p.requires_grad for p in tree_leaves(ts.params))
    assert int(ts.step) == 0 and int(ts.opt["count"]) == 0
    assert ts.rng.dtype == torch.uint8


def test_bf16_train_step_runs_with_master_weights():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("olmo-1b"),
                              dtype="bfloat16")
    state = tstep.init_train_state(0, cfg, device="cpu")
    assert "master" in state.opt
    step = tstep.make_train_step(cfg, AdamWConfig(lr=1e-2))
    gen = torch.Generator().manual_seed(0)
    batch = tstep.make_train_batch(gen, cfg, B, S)
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for p, m in zip(tree_leaves(state.params),
                    tree_leaves(state.opt["master"])):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p.detach(), m.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["minicpm-2b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_train_state_checkpoint_round_trip_is_bit_exact(tmp_path, arch):
    """params (bf16), mu, nu, master, count, step and the generator state
    through the checkpoint store and back; the Mamba mixer's a_log and
    dt_bias stay float32 in the bf16 params and in the master copy."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype="bfloat16")
    state = tstep.init_train_state(4, cfg, device="cpu")
    step = tstep.make_train_step(cfg, AdamWConfig(lr=1e-2))
    batch = tstep.make_train_batch(torch.Generator().manual_seed(1), cfg, B,
                                   S)
    state, _ = step(state, batch)
    store = CheckpointStore(str(tmp_path))
    store.save(1, state)
    like = tstep.init_train_state(5, cfg, device="cpu")
    back = restore_train_state(store, 1, like)
    assert isinstance(back, tstep.TrainState)
    pairs = list(zip(tree_leaves(state.params), tree_leaves(back.params)))
    for key in ("mu", "nu", "master"):
        pairs += zip(tree_leaves(state.opt[key]), tree_leaves(back.opt[key]))
    pairs += [(state.opt["count"], back.opt["count"]),
              (state.step, back.step), (state.rng, back.rng)]
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    assert all(p.requires_grad for p in tree_leaves(back.params))
    manifest = store.manifest(1)["leaves"]
    assert manifest["params.embed"]["dtype"] == "bfloat16"
    mamba = [(tree["layers"][sub]["mamba"][leaf], key)
             for tree, key in ((back.params, "params"),
                               (back.opt["master"], "opt.master"))
             for sub in sorted(back.params["layers"])
             if "mamba" in back.params["layers"][sub]
             for leaf in ("a_log", "dt_bias")]
    assert len(mamba) == (4 * sum(m == "mamba" for m, _ff in cfg.pattern)
                          if cfg.family in ("ssm", "hybrid") else 0)
    for leaf, key in mamba:
        assert leaf.dtype == torch.float32, key
    assert all(v["dtype"] == "float32" for k, v in manifest.items()
               if k.endswith(("mamba.a_log", "mamba.dt_bias")))
    # the restored state trains on as the saved one does
    s1, m1 = step(state, batch)
    s2, m2 = step(back, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_train_state_axes_mirror_the_state():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("glm4-9b"),
                              dtype="bfloat16")
    axes = tstep.train_state_axes(cfg)
    assert axes.params == tlm.param_axes(cfg)
    assert set(axes.opt) == {"mu", "nu", "count", "master"}
    ref = jstep.train_state_axes(dataclasses.replace(jax_smoke("glm4-9b"),
                                                     dtype="bfloat16"))
    assert axes.opt["mu"] == ref.opt["mu"] and axes.step == ref.step


# -- the attention route ------------------------------------------------------


@pytest.fixture
def flash_spy(monkeypatch):
    calls = []

    def spy(q, k, v, causal=True):
        calls.append(q.shape)
        return aops.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(tlayers, "flash_attention", spy)
    return calls


def test_training_attention_takes_sdpa_not_flash(flash_spy):
    jcfg, tcfg = _cfgs("olmo-1b")
    _jp, tp = _params(jcfg)
    _jb, tb = _batch(jcfg, seed=3)
    before = aops.flash_attention.launches
    loss, _parts, grads = tstep.loss_and_grads(tp, tb, tcfg)
    assert flash_spy == []
    assert aops.flash_attention.launches == before
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads))


def test_inference_attention_takes_flash(flash_spy):
    jcfg, tcfg = _cfgs("olmo-1b")
    _jp, tp = _params(jcfg)
    tokens = _batch(jcfg, seed=3)[1]["tokens"]
    with torch.no_grad():
        tlm.forward(tp, tokens, tcfg)
    assert len(flash_spy) == tcfg.n_layers
    # params needing no gradient take it even with grad mode on
    frozen = jax.tree.map(lambda p: p.detach(), tp)
    tlm.forward(frozen, tokens, tcfg)
    assert len(flash_spy) == 2 * tcfg.n_layers
    # prefill of trained weights (autograd leaves) runs under no_grad
    prefill = tstep.make_prefill_step(tcfg)
    logits, cache = prefill(tp, {"tokens": tokens})
    assert len(flash_spy) == 3 * tcfg.n_layers
    assert not logits.requires_grad


def test_sdpa_matches_reference_layer():
    from repro.models import layers as jlayers

    jcfg, tcfg = _cfgs("glm4-9b")
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 16, tcfg.n_heads_padded, tcfg.d_head),
                            dtype=np.float32)
    k = rng.standard_normal((2, 16, tcfg.n_kv_heads_padded, tcfg.d_head),
                            dtype=np.float32)
    v = rng.standard_normal(k.shape, dtype=np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jax.numpy.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        tlayers._sdpa(*t, tcfg).numpy(),
        np.asarray(jlayers._sdpa(*j, jcfg)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlayers._sdpa_chunked(*t, tcfg, 4).numpy(),
        np.asarray(jlayers._sdpa_chunked(*j, jcfg, 4)), rtol=1e-5,
        atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        tlayers._sdpa_chunked(*t, tcfg, 5)


def test_serve_step_decodes_after_prefill():
    jcfg, tcfg = _cfgs("phi3-mini-3.8b")
    _jp, tp = _params(jcfg)
    tokens = _batch(jcfg, seed=4)[1]["tokens"][:, :8]
    logits, cache = tstep.make_prefill_step(tcfg, max_seq=10)(
        tp, {"tokens": tokens})
    nxt = logits[:, -1, :tcfg.vocab].argmax(-1, keepdim=True)
    out, _cache = tstep.make_serve_step(tcfg)(tp, cache, nxt, 8)
    full, _ = tlm.forward(jax.tree.map(lambda p: p.detach(), tp),
                          torch.cat([tokens, nxt], dim=1), tcfg)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_train_state_from_jax_keeps_float32_mamba_leaves():
    """A bf16 jamba state: a_log and dt_bias float32 in the params, the
    moments and the master copy; the expert stacks bf16 in the params."""
    jcfg = dataclasses.replace(jax_smoke("jamba-v0.1-52b"), dtype="bfloat16")
    js = jstep.init_train_state(jax.random.PRNGKey(3), jcfg)
    ts = train_state_from_jax(dataclasses.asdict(jax.tree.map(np.asarray,
                                                              js)))
    for tree in (ts.params, ts.opt["mu"], ts.opt["master"]):
        mamba = tree["layers"]["sub_0"]["mamba"]
        assert mamba["a_log"].dtype == mamba["dt_bias"].dtype == \
            torch.float32
    assert ts.params["layers"]["sub_1"]["moe"]["w_up"].dtype == \
        torch.bfloat16
    assert ts.opt["master"]["layers"]["sub_1"]["moe"]["w_up"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        ts.params["layers"]["sub_0"]["mamba"]["a_log"].detach().numpy(),
        np.asarray(js.params["layers"]["sub_0"]["mamba"]["a_log"]))


@pytest.mark.parametrize("arch", NEW)
def test_training_job_runs_every_family(arch, tmp_path):
    from repro_torch.launch.train import run_training_job

    out = run_training_job(arch=arch, smoke=True, steps=2, batch=2, seq=16,
                           workdir=str(tmp_path), device="cpu")
    assert out["final_state"] == "SUCCEEDED"
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
