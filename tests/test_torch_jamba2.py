"""jamba2-mini (AI21-Jamba2-Mini) at its smoke widths against the plain
reference the benchmark holds the card to (``portbench/reference/
jamba.py``), on weights drawn in Hugging Face's layout and laid out as
the port's tree by the benchmark's generator, on the host in float32: the forward's logits, prefill then
decode through the cache against the full forward, the dropless expert
layer against a loop over the tokens, each published form the config
switches on turned back to the reference's, and two runs' bits.

Marked ``cuda`` (skipped without a card): the smoke config served on the
card against the host, and the dropless layer's bf16 grouped products on
the card against the host's loop.  This file imports no jax, so on the
card: ``PYTHONPATH=src python -m pytest --noconftest
tests/test_torch_jamba2.py -q``.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.checks import jamba as check_jamba  # noqa: E402
from portbench.generators import jamba as gen_jamba  # noqa: E402
from portbench.reference import jamba as ref  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

# the configuration's published keys at the port's smoke widths (the
# benchmark's host size)
HF = check_jamba.small(json.loads(
    (ROOT / "portbench" / "configs" / "jamba2-mini.json").read_text()))
# float32 on the host: the chunked doubling scan against the sequential
# one, and other orders of sums, move logits by ~2e-6 of the largest
TOL = 1e-4
PROMPT, GEN = 24, 6


def _weights(cfg, seed=0, skew=False):
    """Smoke weights as the benchmark draws them: (Hugging Face's flat
    dict, the port's tree of views of it).  ``skew``: every embedding row
    shifted by 1 and each router's expert 0 row set to 1, so that nearly
    every token routes to expert 0 and a capacity would drop some."""
    hf = gen_jamba.draw(HF, torch.Generator().manual_seed(seed))
    if skew:
        hf["model.embed_tokens.weight"] += 1.0
        for name, w in hf.items():
            if name.endswith("router.weight"):
                w[0] = 1.0
    return hf, gen_jamba.program(hf, HF, cfg)


def _prompts(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, HF["vocab_size"], (2, PROMPT), generator=g)


def _served_gap(cfg, weights, prompts):
    """The largest position gap of a served batch against the
    reference."""
    hf, params = weights
    out = serve.generate(params, prompts, cfg, gen=GEN, keep_logits=True)
    seq = torch.cat([prompts, out["generated"].long()], dim=1)
    want = ref.logits(hf, seq, HF, range(PROMPT - 1, PROMPT + GEN))
    assert out["logits"].shape == want.shape == (2, 1 + GEN, HF["vocab_size"])
    return float(check_jamba.position_gaps(out["logits"], want).max())


def test_forward_logits_match_the_reference():
    cfg = get_smoke_config("jamba2-mini")
    (hf, params), toks = _weights(cfg), _prompts()
    got, _aux = lm.forward(params, toks, cfg)
    want = ref.logits(hf, toks, HF, range(PROMPT))
    assert float(check_jamba.position_gaps(got[..., :cfg.vocab],
                                           want).max()) < TOL


@pytest.mark.parametrize("skew", [False, True])
def test_prefill_then_decode_match_the_full_forward(skew):
    cfg = get_smoke_config("jamba2-mini")
    assert _served_gap(cfg, _weights(cfg, skew=skew), _prompts()) < TOL


@pytest.mark.parametrize("switch", ["rope", "ssm_norms", "router_renorm",
                                    "moe_dropless"])
def test_each_published_form_turned_back_breaks_the_comparison(switch):
    """The reference's form (the field's default) in place of the
    published one moves the logits by far more than the tolerance.  A
    capacity drops only where routing is skewed, so the dropless form is
    turned back on the skewed weights (on which the others hardly show:
    expert 0 takes nearly all of each token's weight, and the shifted
    embeddings make the tokens alike)."""
    cfg = get_smoke_config("jamba2-mini")
    default = {f.name: f.default for f in dataclasses.fields(cfg)}[switch]
    assert getattr(cfg, switch) != default
    back = dataclasses.replace(cfg, **{switch: default})
    weights = _weights(cfg, skew=switch == "moe_dropless")
    toks = _prompts()
    assert _served_gap(cfg, weights, toks) < TOL
    assert _served_gap(back, weights, toks) > 100 * TOL


def _loop(params, x, cfg):
    """The MoE layer a token at a time: its top-k of the softmax, each
    chosen expert's SwiGLU in float32, weighted and summed."""
    probs = torch.softmax(x.float() @ params["router"].float(), -1)
    w, ids = torch.topk(probs, cfg.top_k, -1)
    out = torch.zeros(x.shape, dtype=torch.float32)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e, xt = int(ids[t, j]), x[t].float()
            h = F.silu(xt @ params["w_gate"][e].float()) * (
                xt @ params["w_up"][e].float())
            out[t] += w[t, j] * (h @ params["w_down"][e].float())
    return out


@pytest.mark.parametrize("one_expert", [False, True])
def test_dropless_layer_matches_a_loop_over_the_tokens(monkeypatch,
                                                       one_expert):
    """Every routed pair computed once, and nothing else: the grouped
    products take the B·S·k routed rows, sorted by expert, with offsets
    ending at their count (every token on expert 0 too)."""
    cfg = get_smoke_config("jamba2-mini")
    sub = lm._layer(_weights(cfg)[1]["layers"], 0)["sub_1"]["moe"]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 40, cfg.d_model, generator=g)
    if one_expert:
        x += 1.0
        sub["router"][:, 0] = 1.0
    seen = []
    grouped = torch._grouped_mm

    def spy(a, b, offs=None, **kw):
        seen.append((a.shape[0], offs.clone()))
        return grouped(a, b, offs=offs, **kw)
    monkeypatch.setattr(torch, "_grouped_mm", spy)
    got, _aux = moe.moe_ffn(sub, x, cfg)
    want = _loop(sub, x.reshape(-1, cfg.d_model), cfg).reshape(x.shape)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    pairs = 3 * 40 * cfg.top_k
    assert len(seen) == 3
    for rows, offs in seen:
        assert rows == pairs and int(offs[-1]) == pairs
        assert offs.dtype == torch.int32 and offs.shape == (cfg.n_experts,)
    if one_expert:
        assert int(seen[0][1][0]) == 3 * 40


def test_two_runs_give_the_same_bits():
    cfg = get_smoke_config("jamba2-mini")
    (_hf, params), toks = _weights(cfg, skew=True), _prompts()
    a = serve.generate(params, toks, cfg, gen=GEN, keep_logits=True)
    b = serve.generate(params, toks, cfg, gen=GEN, keep_logits=True)
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["generated"], b["generated"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_serves_like_the_host(card):
    """The smoke config's served logits on the card within 1e-4 of the
    host's largest, tokens equal (float32)."""
    cfg = get_smoke_config("jamba2-mini")
    (_hf, params), toks = _weights(cfg, skew=True), _prompts()
    host = serve.generate(params, toks, cfg, gen=GEN, keep_logits=True)
    got = serve.generate(_to(params, card), toks.to(card), cfg, gen=GEN,
                         keep_logits=True)
    assert torch.equal(got["generated"].cpu(), host["generated"])
    assert float(check_jamba.position_gaps(got["logits"].cpu(),
                                           host["logits"]).max()) < TOL


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_dropless_bf16_grouped_products_on_the_card(card):
    """The bf16 grouped products (the cell's path) on uneven routing at
    16 experts against the host's float32 loop, within bf16 rounding;
    two launches bitwise equal."""
    cfg = dataclasses.replace(get_smoke_config("jamba2-mini"), d_model=256,
                              d_ff_expert=512, n_experts=16,
                              dtype="bfloat16")
    g = torch.Generator().manual_seed(7)
    sub = {"router": torch.randn(256, 16, generator=g) * 0.2,
           "w_gate": torch.randn(16, 256, 512, generator=g) / 16,
           "w_up": torch.randn(16, 256, 512, generator=g) / 16,
           "w_down": torch.randn(16, 512, 256, generator=g) / 512 ** 0.5}
    sub = {k: v.to(torch.bfloat16) for k, v in sub.items()}
    x = (torch.randn(2, 300, 256, generator=g) + 0.3).to(torch.bfloat16)
    want = _loop(sub, x.reshape(-1, 256), cfg).reshape(x.shape)
    csub = _to(sub, card)
    a, _ = moe.moe_ffn(csub, x.to(card), cfg)
    b, _ = moe.moe_ffn(csub, x.to(card), cfg)
    assert torch.equal(a, b)
    err = float((a.float().cpu() - want).abs().max())
    assert err < 3e-2 * float(want.abs().max())
