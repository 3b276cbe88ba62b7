"""A Jamba model's work counts, the card's bf16 peak, and the expert
products' kernel names: the yardstick of the Jamba cells' shares.

The counts follow ``JambaForCausalLM``'s equations (the configuration's
published keys), never what a kernel does: the products' multiply-adds as two
operations each, attention's over the causal pairs it needs, the experts'
over the routed (token, choice) pairs alone.  The peak is NVIDIA's data
sheet for the H100 SXM at its 700 W limit (dense, no sparsity).
"""

from __future__ import annotations

from portbench import serving

# bf16 on the tensor cores (dense).
PEAK_BF16_FLOPS = 989e12

# The port's expert products (``models.moe._grouped_experts``): the
# grouped GEMM that ``torch._grouped_mm`` launches for bf16 on sm90, and
# the kernel that lays out its per-expert problems from the offsets.  No
# other operation of a serving job launches either.
EXPERT_KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def is_expert_kernel(name: str) -> bool:
    return any(k in name for k in EXPERT_KERNELS)


def program_counts():
    """The program's counts over the traced window: prompt positions
    (``lm.prefill_tokens``), decoded positions (``lm.decode_tokens``) and
    (token, choice) pairs its experts computed (``moe.routed_pairs``), or
    None where the program keeps no such counters."""
    n = [serving.count(name) for name in
         ("lm.prefill_tokens", "lm.decode_tokens", "moe.routed_pairs")]
    if n[0] is None or n[2] is None:
        return None
    return n[0], n[1] or 0, n[2]


def _layers(config: dict):
    """(mixer, ffn) of each layer: "attn" | "mamba", "moe" | "dense"."""
    for i in range(config["num_hidden_layers"]):
        yield ("attn" if i % config["attn_layer_period"]
               == config["attn_layer_offset"] else "mamba",
               "moe" if i % config["expert_layer_period"]
               == config["expert_layer_offset"] else "dense")


def moe_layers(config: dict) -> int:
    return sum(ff == "moe" for _, ff in _layers(config))


def expert_pair_flops(config: dict) -> int:
    """One routed pair through one expert's SwiGLU: 3 products of d x f."""
    return 6 * config["hidden_size"] * config["intermediate_size"]


def token_flops(config: dict) -> int:
    """One token through the layers, less attention's pairs, the routed
    experts and the head: the projections, the conv, the dense FFNs and
    the router."""
    d, f = config["hidden_size"], config["intermediate_size"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = d // heads
    di, st = config["mamba_expand"] * d, config["mamba_d_state"]
    dtr = config["mamba_dt_rank"]
    total = 0
    for mixer, ff in _layers(config):
        if mixer == "attn":
            total += 2 * d * (2 * heads * hd + 2 * kv * hd)
        else:
            total += 2 * (d * 2 * di + di * (dtr + 2 * st) + dtr * di
                          + di * d + config["mamba_d_conv"] * di)
        if ff == "moe":
            total += 2 * d * config["num_experts"]
        else:
            total += 6 * d * f
    return total


def attention_flops(config: dict, position: int) -> int:
    """The query at ``position`` against the keys 0 .. position: q.k and
    p.v, 4 D operations a pair a head, in every attention layer."""
    n_attn = sum(m == "attn" for m, _ in _layers(config))
    hd = config["hidden_size"] // config["num_attention_heads"]
    return n_attn * 4 * config["num_attention_heads"] * hd * (position + 1)


def head_flops(config: dict) -> int:
    return 2 * config["hidden_size"] * config["vocab_size"]


def job_flops(config: dict, prefill_tokens: int, decode_tokens: int,
              routed_pairs: int) -> int:
    """The work of serving ``prefill_tokens`` prompt positions, in prompts
    of ``prompt_len``, and ``decode_tokens`` decoded ones, a step a
    prompt at positions prompt_len, prompt_len + 1, ...: every token
    through the layers, attention over its causal pairs, the head at each
    prompt's last position and at every decoded one, and ``routed_pairs``
    (token, choice) pairs through an expert (top-k a token a MoE layer
    where routing drops nothing)."""
    p = config["prompt_len"]
    prompts = prefill_tokens // p
    steps = decode_tokens // prompts if prompts else 0
    prefill_attn = sum(attention_flops(config, t) for t in range(p))
    decode_attn = sum(attention_flops(config, p + i) for i in range(steps))
    return ((prefill_tokens + decode_tokens) * token_flops(config)
            + routed_pairs * expert_pair_flops(config)
            + prompts * (prefill_attn + decode_attn)
            + (prompts + decode_tokens) * head_flops(config))


def routed_prefill_flops(config: dict, prefill_tokens: int) -> int:
    """The experts' work in the prefills: each prompt position's top-k
    pairs through every MoE layer."""
    return (prefill_tokens * config["num_experts_per_tok"]
            * moe_layers(config) * expert_pair_flops(config))
