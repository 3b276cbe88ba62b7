"""A Jamba model's inputs (Hugging Face ``model_type`` "jamba"): prompt
token ids, and its weights.

``dataset`` draws one prompt batch, (batch, prompt_len) int64 ids uniform
over ``vocab_size``.

``shared`` draws the weights once a run, in ``JambaForCausalLM``'s own
layout (:func:`draw`): a flat dict of its state dict's names and shapes,
sized from the configuration's published keys alone, nothing of the
program read.  The plain reference (``portbench/reference/jamba.py``)
reads that dict and nothing else.  :func:`program` then lays the same
tensors out as the port's parameter tree, as views where the layout
allows, and holds the result to the port's declared shapes and dtypes:
a fault in the port's declarations, its initialisation or its order of
sub-layers cannot be shared by the reference.  ``shared`` returns
``{"hf": <the flat dict>, "program": <the port's tree>}``.

The draw (every tensor in the model's dtype but ``A_log`` and the
``dt_proj`` bias, float32 as the port and Mamba's kernels keep them):
each linear weight normal with sd 1/sqrt(its input width); the embedding
normal with sd 1; every RMSNorm weight and the Mamba ``D`` uniform in
[0.75, 1.25), so that a norm or a skip left out shows; the conv normal
with sd 1/sqrt(d_conv), its bias normal with sd 0.1; ``A_log`` the log of
Mamba's S4D-real A, 1 .. d_state a channel, each scaled by a draw in
[0.75, 1.25); the ``dt_proj`` bias Mamba's: the inverse softplus of a dt
log-uniform in [1e-3, 1e-1].  Each layer's experts share one allocation a
projection, expert e's weight the e-th slice under its own name.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def _pattern(config: dict) -> List[tuple]:
    """(mixer, ffn) of each layer: "attn" | "mamba", "moe" | "dense"."""
    ap, ao = config["attn_layer_period"], config["attn_layer_offset"]
    ep, eo = config["expert_layer_period"], config["expert_layer_offset"]
    return [("attn" if i % ap == ao else "mamba",
             "moe" if i % ep == eo else "dense")
            for i in range(config["num_hidden_layers"])]


def _published(config: dict) -> dict:
    """The port's config fields as the published keys give them."""
    heads = config["num_attention_heads"]
    period = math.lcm(config["attn_layer_period"],
                      config["expert_layer_period"])
    return {
        "n_layers": config["num_hidden_layers"],
        "d_model": config["hidden_size"],
        "vocab": config["vocab_size"],
        "n_heads": heads,
        "n_kv_heads": config["num_key_value_heads"],
        "d_head": config["hidden_size"] // heads,
        "d_ff": config["intermediate_size"],
        "d_ff_expert": config["intermediate_size"],
        "n_experts": config["num_experts"],
        "top_k": config["num_experts_per_tok"],
        "ssm_state": config["mamba_d_state"],
        "ssm_conv": config["mamba_d_conv"],
        "ssm_expand": config["mamba_expand"],
        "dt_rank": config["mamba_dt_rank"],
        "tie_embeddings": config["tie_word_embeddings"],
        "norm": "rmsnorm",
        "act": "swiglu" if config["hidden_act"] == "silu" else None,
        "pattern": tuple(_pattern(dict(config,
                                       num_hidden_layers=period))),
        "dtype": config["dtype"],
        "rope": False,
        "ssm_norms": True,
        "router_renorm": False,
        "moe_dropless": True,
    }


def model_config(config: dict):
    """The port's config for ``config``: ``port_arch``'s published config
    (its smoke config where ``config["smoke"]``), which must agree with
    every published key the configuration states."""
    from repro_torch.configs import get_config, get_smoke_config
    name = config["port_arch"]
    cfg = get_smoke_config(name) if config.get("smoke") else get_config(name)
    wrong = {k: (getattr(cfg, k), v) for k, v in _published(config).items()
             if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"{config['name']}: the port's {cfg.name} differs "
                         f"from the configuration in {wrong}")
    return cfg


def dataset(config: dict, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, config["vocab_size"],
                         (config["batch"], config["prompt_len"]),
                         generator=gen, device=gen.device)


class _Draw:
    """Draws on the generator's device, in the order asked."""

    def __init__(self, gen: torch.Generator, dtype: torch.dtype) -> None:
        self.gen, self.dtype, self.dev = gen, dtype, gen.device

    def normal(self, shape, sd: float, dtype=None) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype or self.dtype, device=self.dev)
        return t.normal_(0.0, sd, generator=self.gen)

    def linear(self, out: int, inp: int) -> torch.Tensor:
        return self.normal((out, inp), inp ** -0.5)

    def around_one(self, shape) -> torch.Tensor:
        t = torch.empty(shape, dtype=self.dtype, device=self.dev)
        return t.uniform_(0.75, 1.25, generator=self.gen)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.dev)
        return t.uniform_(lo, hi, generator=self.gen)


def draw(config: dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The weights in ``JambaForCausalLM``'s state-dict names and shapes
    (linear weights (out, in)), on the generator's device."""
    d, v = config["hidden_size"], config["vocab_size"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = d // heads
    di = config["mamba_expand"] * d
    st, dtr = config["mamba_d_state"], config["mamba_dt_rank"]
    kc, f, e = config["mamba_d_conv"], config["intermediate_size"], \
        config["num_experts"]
    r = _Draw(gen, getattr(torch, config["dtype"]))
    w = {"model.embed_tokens.weight": r.normal((v, d), 1.0)}
    for i, (mixer, ffn) in enumerate(_pattern(config)):
        p = f"model.layers.{i}."
        w[p + "input_layernorm.weight"] = r.around_one((d,))
        if mixer == "attn":
            a = p + "self_attn."
            w[a + "q_proj.weight"] = r.linear(heads * hd, d)
            w[a + "k_proj.weight"] = r.linear(kv * hd, d)
            w[a + "v_proj.weight"] = r.linear(kv * hd, d)
            w[a + "o_proj.weight"] = r.linear(d, heads * hd)
        else:
            m = p + "mamba."
            w[m + "in_proj.weight"] = r.linear(2 * di, d)
            w[m + "conv1d.weight"] = r.normal((di, 1, kc), kc ** -0.5)
            w[m + "conv1d.bias"] = r.normal((di,), 0.1)
            w[m + "x_proj.weight"] = r.linear(dtr + 2 * st, di)
            w[m + "dt_layernorm.weight"] = r.around_one((dtr,))
            w[m + "b_layernorm.weight"] = r.around_one((st,))
            w[m + "c_layernorm.weight"] = r.around_one((st,))
            w[m + "dt_proj.weight"] = r.linear(di, dtr)
            dt = torch.exp(r.uniform((di,), math.log(1e-3), math.log(1e-1)))
            w[m + "dt_proj.bias"] = dt + torch.log(-torch.expm1(-dt))
            a_mat = torch.arange(1, st + 1, dtype=torch.float32,
                                 device=r.dev).expand(di, st)
            w[m + "A_log"] = torch.log(a_mat * r.uniform((di, st), 0.75,
                                                          1.25))
            w[m + "D"] = r.around_one((di,))
            w[m + "out_proj.weight"] = r.linear(d, di)
        w[p + "pre_ff_layernorm.weight"] = r.around_one((d,))
        ff = p + "feed_forward."
        if ffn == "moe":
            w[ff + "router.weight"] = r.linear(e, d)
            for name, shape, sd in (("gate_proj", (e, f, d), d ** -0.5),
                                    ("up_proj", (e, f, d), d ** -0.5),
                                    ("down_proj", (e, d, f), f ** -0.5)):
                stack = r.normal(shape, sd)
                for x in range(e):
                    w[f"{ff}experts.{x}.{name}.weight"] = stack[x]
        else:
            w[ff + "gate_proj.weight"] = r.linear(f, d)
            w[ff + "up_proj.weight"] = r.linear(f, d)
            w[ff + "down_proj.weight"] = r.linear(d, f)
    w["model.final_layernorm.weight"] = r.around_one((d,))
    w["lm_head.weight"] = r.linear(v, d)
    return w


def _stacked(ws: List[torch.Tensor]) -> torch.Tensor:
    """``ws`` stacked on a new leading axis: a view where they lie one
    after another in one allocation, else a copy."""
    base = ws[0]
    view = base.as_strided((len(ws), *base.shape),
                           (base.numel(), *base.stride()),
                           base.storage_offset())
    if all(base.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
           and view[i].data_ptr() == t.data_ptr()
           and view[i].stride() == t.stride() for i, t in enumerate(ws)):
        return view
    return torch.stack(ws)


def _layer(w: Dict[str, torch.Tensor], i: int, config: dict,
           mixer: str, ffn: str) -> dict:
    """Layer ``i`` of ``w`` in the port's names and (in, out) layout."""
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["hidden_size"] // heads
    p = f"model.layers.{i}."
    sub = {"norm1": {"scale": w[p + "input_layernorm.weight"]},
           "norm2": {"scale": w[p + "pre_ff_layernorm.weight"]}}
    if mixer == "attn":
        a = p + "self_attn."
        sub["attn"] = {
            "wq": w[a + "q_proj.weight"].t().unflatten(1, (heads, hd)),
            "wk": w[a + "k_proj.weight"].t().unflatten(1, (kv, hd)),
            "wv": w[a + "v_proj.weight"].t().unflatten(1, (kv, hd)),
            "wo": w[a + "o_proj.weight"].t().unflatten(0, (heads, hd)),
        }
    else:
        m = p + "mamba."
        sub["mamba"] = {
            "in_proj": w[m + "in_proj.weight"].t(),
            "conv_w": w[m + "conv1d.weight"][:, 0].t(),
            "conv_b": w[m + "conv1d.bias"],
            "x_proj": w[m + "x_proj.weight"].t(),
            "dt_norm": w[m + "dt_layernorm.weight"],
            "b_norm": w[m + "b_layernorm.weight"],
            "c_norm": w[m + "c_layernorm.weight"],
            "dt_proj": w[m + "dt_proj.weight"].t(),
            "dt_bias": w[m + "dt_proj.bias"],
            "a_log": w[m + "A_log"],
            "d_skip": w[m + "D"],
            "out_proj": w[m + "out_proj.weight"].t(),
        }
    ff = p + "feed_forward."
    if ffn == "moe":
        def experts(name):
            return _stacked([w[f"{ff}experts.{x}.{name}.weight"]
                             for x in range(config["num_experts"])])
        sub["moe"] = {"router": w[ff + "router.weight"].t(),
                      "w_gate": experts("gate_proj").transpose(1, 2),
                      "w_up": experts("up_proj").transpose(1, 2),
                      "w_down": experts("down_proj").transpose(1, 2)}
    else:
        sub["mlp"] = {"w_gate": w[ff + "gate_proj.weight"].t(),
                      "w_up": w[ff + "up_proj.weight"].t(),
                      "w_down": w[ff + "down_proj.weight"].t()}
    return sub


def _tree_map(fn, *trees):
    return {k: _tree_map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


def _paths(tree: dict, at: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, f"{at}{k}/") if isinstance(v, dict)
                   else {at + k: (tuple(v.shape), v.dtype)})
    return out


def program(w: Dict[str, torch.Tensor], config: dict, cfg) -> dict:
    """The weights ``w`` as the port's tree for ``cfg``: layer g·P + j of
    the published stack is period g's sub-layer ``sub_j`` (P the period),
    stacked over the periods.  Raises where a leaf's name, shape or dtype
    is not the one the port declares."""
    from repro_torch.models import lm

    layers = _pattern(config)
    period = len(cfg.pattern)
    subs = [_layer(w, i, config, *layers[i]) for i in range(len(layers))]
    stacked = {f"sub_{j}": _tree_map(lambda *ts: _stacked(list(ts)),
                                     *subs[j::period])
               for j in range(period)}
    tree = {"embed": w["model.embed_tokens.weight"], "layers": stacked,
            "final_norm": {"scale": w["model.final_layernorm.weight"]},
            "lm_head": w["lm_head.weight"].t()}
    got, want = _paths(tree), _paths(lm.abstract_params(cfg))
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{config['name']}: the weights do not lay out as "
                         f"the port declares them: {diff[:6]}")
    return tree


def shared(config: dict, gen: torch.Generator) -> dict:
    """The model's weights on the generator's device, in both layouts."""
    cfg = model_config(config)
    w = draw(config, gen)
    return {"hf": w, "program": program(w, config, cfg)}


def check(config: dict) -> None:
    """The prompt batch fits the vocabulary and the stated context."""
    if not (config["batch"] >= 1 and config["prompt_len"] >= 1
            and config["gen"] >= 1):
        raise ValueError(f"{config['name']}: batch, prompt_len and gen must "
                         f"be positive")
    if config["prompt_len"] + config["gen"] > config[
            "max_position_embeddings"]:
        raise ValueError(f"{config['name']}: prompt and answer exceed the "
                         f"context")
