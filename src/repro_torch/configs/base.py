"""Model/shape configuration dataclasses shared by every architecture."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# (mixer, ff) per sub-layer of one scan period.
# mixer: "attn" | "mamba";  ff: "dense" | "moe" | None (mamba1 has no FFN)
Pattern = Tuple[Tuple[str, Optional[str]], ...]

DENSE_PATTERN: Pattern = (("attn", "dense"),)
MOE_PATTERN: Pattern = (("attn", "moe"),)
MAMBA_PATTERN: Pattern = (("mamba", None),)
# Jamba: 1 attention per 8 layers (1:7), MoE every other layer.
JAMBA_PATTERN: Pattern = (
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("attn", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    # attention (0s for attn-free archs)
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    rope_theta: float = 10_000.0
    # normalization: rmsnorm | layernorm | nonparam_ln (OLMo)
    norm: str = "rmsnorm"
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    # layer pattern (period); n_layers % len(pattern) == 0
    pattern: Pattern = DENSE_PATTERN
    # modality frontend stub
    frontend: str = "none"       # none | vlm | audio
    prefix_len: int = 0          # frames/patches prepended by the stub
    # numerics / compile strategy
    dtype: str = "bfloat16"
    remat: str = "full"          # none | dots | full
    scan_layers: bool = True
    # query-chunked (flash-style streaming) attention above this seq len;
    # bounds the live score buffer to (B, H, chunk, S).  0 = never chunk.
    attn_chunk: int = 2048
    # head-count padding granularity (16 = the production TP degree;
    # smoke configs use 4 to exercise the masked-padding path cheaply)
    head_pad_multiple: int = 16
    # chunked cross-entropy: split the batch into this many strided
    # sub-chunks and recompute logits per chunk in the backward pass, so
    # the (B, S, vocab) f32 logits tensor is never materialized (decisive
    # for vocab >= 92k).  0 = off; analysis compiles override to 0.
    loss_chunk: int = 16
    # MoE dispatch group size (tokens): the (group*k, d) gather/scatter
    # chain is the top-k dispatch's memory spine (8x token volume for
    # OLMoE); chunks are scanned with per-chunk remat.  0 = whole sequence.
    moe_chunk: int = 1024
    ssm_chunk: int = 128         # associative-scan chunk length
    # source note: [reference; verification tier]
    source: str = ""

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_heads_padded(self) -> int:
        """Megatron-style head padding to a TP-friendly multiple (16).

        Published head counts that don't divide 16-way TP (36, 24) are
        padded in the *layout*; padded heads are masked to exactly zero
        output in models.layers.attention, so semantics match the
        published config (see DESIGN.md §7)."""
        m = self.head_pad_multiple
        return -(-self.n_heads // m) * m if self.n_heads else 0

    @property
    def n_kv_heads_padded(self) -> int:
        """KV heads are padded only in the MHA case (kv == heads).  GQA
        archs (kv 2/8) keep their published KV count: replicating a few KV
        heads is cheaper than 2-8x padded KV cache; their decode caches
        shard over the sequence dim instead (launch/cells.rules_for)."""
        if self.n_kv_heads and self.n_kv_heads == self.n_heads:
            return self.n_heads_padded
        return self.n_kv_heads

    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding to a TP-friendly multiple (256).

        The embedding table and lm_head are laid out padded so "vocab" can
        shard over 16-way model parallelism even for odd published vocabs
        (92553, 122753); padded logit columns are masked to -inf in
        models.lm._logits, so semantics match the published config exactly.
        """
        return -(-self.vocab // 256) * 256

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {self.period}"
        )
        return self.n_layers // self.period

    @property
    def attention_free(self) -> bool:
        return all(mixer != "attn" for mixer, _ in self.pattern)

    @property
    def has_attention(self) -> bool:
        return not self.attention_free

    @property
    def full_attention(self) -> bool:
        """True if *every* mixer is full (quadratic) attention."""
        return all(mixer == "attn" for mixer, _ in self.pattern)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d = self.d_model
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        for mixer, ff in self.pattern * self.n_groups:
            if mixer == "attn":
                total += d * self.n_heads * self.d_head        # q
                total += 2 * d * self.n_kv_heads * self.d_head  # k, v
                total += self.n_heads * self.d_head * d         # o
            else:  # mamba1 block
                di, st = self.d_inner, self.ssm_state
                total += d * 2 * di          # in_proj (x, z)
                total += di * self.ssm_conv  # depthwise conv
                total += di * (self.dt_rank + 2 * st)  # x_proj
                total += self.dt_rank * di + di        # dt_proj (+bias)
                total += di * st + di                  # A_log, D
                total += di * d              # out_proj
            if ff == "dense":
                total += 3 * d * self.d_ff if self.act == "swiglu" \
                    else 2 * d * self.d_ff
            elif ff == "moe":
                total += d * self.n_experts  # router
                per = 3 * d * self.d_ff_expert if self.act == "swiglu" \
                    else 2 * d * self.d_ff_expert
                total += self.n_experts * per
            total += 2 * d if self.norm != "nonparam_ln" else 0
        total += d if self.norm != "nonparam_ln" else 0  # final norm
        return total

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: only top_k experts count)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        per_expert = (3 if self.act == "swiglu" else 2) * d * self.d_ff_expert
        inactive = 0
        for _, ff in self.pattern * self.n_groups:
            if ff == "moe":
                inactive += (self.n_experts - self.top_k) * per_expert
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def step_fn(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell (see DESIGN §6)."""
    if shape.name == "long_500k" and cfg.full_attention:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment)"
        )
    return True, ""
