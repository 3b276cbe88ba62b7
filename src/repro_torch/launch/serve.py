"""Batched LM serving driver: prefill, then greedy or sampled decode.

The counterpart of the reference's ``repro/launch/serve.py``, eager (no
``torch.compile``), for every arch of the registry: dense, MoE, Mamba,
the hybrid and the two stub-frontend backbones (served on tokens alone,
as the reference's ``serve`` is).  Prefill attention runs the
hand-written flash kernel; decode runs one-token steps against the cache
(K/V, and the Mamba sub-layers' conv and ssm states).  Weights are
synthetic (:func:`repro_torch.models.lm.init_params`): nothing is
downloaded.

Runs on the CUDA card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it raises instead of running on the host.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \\
        --batch 4 --prompt-len 16 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cancellation import CancellationToken
from repro_torch.models import lm
from repro_torch.runtime import backend as backend_mod
from repro_torch.runtime import spans

PREFILL, DECODE = "repro_torch.lm.prefill", "repro_torch.lm.decode"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits: torch.Tensor, cfg: ModelConfig, temperature: float,
                generator: torch.Generator) -> torch.Tensor:
    """(B, 1, vocab_padded) logits -> (B, 1) int64 tokens."""
    last = logits[:, -1, :cfg.vocab]
    if temperature > 0:
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return last.argmax(dim=-1, keepdim=True)


def generate(params, prompts: torch.Tensor, cfg: ModelConfig, *, gen: int,
             temperature: float = 0.0,
             token: Optional[CancellationToken] = None,
             generator: Optional[torch.Generator] = None,
             keep_logits: bool = False) -> dict:
    """Prefill ``prompts`` (B, P), then decode up to ``gen`` tokens.

    Returns the generated tokens (B, n) int32 (None if none), the prefill's
    last-position logits, whether every logit of the run was finite, and the
    prefill and decode wall times (host clock up to a device synchronise).
    ``keep_logits=True`` also returns ``logits`` (B, 1 + n, vocab) float32
    on the prompts' device: the prompt's last position's and each decode
    step's, those of positions P - 1 .. P + n - 1.  The prefill and the
    decode loop are the spans ``repro_torch.lm.prefill`` and
    ``repro_torch.lm.decode``, each closed after its synchronise.
    """
    device = prompts.device
    batch, prompt_len = prompts.shape
    _sync(device)
    t0 = time.time()
    with spans.span(PREFILL):
        logits, cache = lm.prefill_step(params, prompts, cfg,
                                        max_seq=prompt_len + gen)
        prefill_logits = logits
        kept = [logits[:, -1, :cfg.vocab]] if keep_logits else None
        finite = torch.isfinite(logits).all()
        _sync(device)
    t_prefill = time.time() - t0

    out: List[torch.Tensor] = []
    tok = _next_token(logits, cfg, temperature, generator)
    t0 = time.time()
    with spans.span(DECODE):
        for i in range(gen):
            if token is not None and token.cancelled():
                break
            out.append(tok)
            logits, cache = lm.decode_step(params, cache, tok,
                                           prompt_len + i, cfg)
            if keep_logits:
                kept.append(logits[:, -1, :cfg.vocab])
            finite &= torch.isfinite(logits).all()
            tok = _next_token(logits, cfg, temperature, generator)
        _sync(device)
    t_decode = time.time() - t0
    result = {
        "generated": (torch.cat(out, dim=1).to(torch.int32) if out else None),
        "prefill_logits": prefill_logits,
        "logits_finite": bool(finite),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": batch * len(out) / max(t_decode, 1e-9),
    }
    if keep_logits:
        result["logits"] = torch.stack(kept, dim=1)
    return result


def serve_batch(
    *,
    arch: str,
    smoke: bool,
    batch: int,
    prompt_len: int,
    gen: int,
    temperature: float = 0.0,
    token: CancellationToken | None = None,
    seed: int = 0,
    device: str = "cuda",
):
    """Serve one batch of random prompts on synthetic weights.

    The weights, the prompts and the samples come, in that order, from one
    ``torch.Generator`` on the device seeded by ``seed``.  Returns the
    reference's dict (``generated``, ``prefill_s``, ``decode_s``,
    ``tokens_per_s``) plus ``prefill_logits`` and ``logits_finite``.
    """
    be = backend_mod.load(device)
    dev = be.device
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(generator, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=generator, device=dev)
    return generate(params, prompts, cfg, gen=gen, temperature=temperature,
                    token=token, generator=generator)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = serve_batch(
        arch=args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen,
        temperature=args.temperature, device=args.device,
    )
    print(f"prefill {out['prefill_s']:.2f}s; decode {out['decode_s']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s)")
    sample = out["generated"]
    print("sample:", [] if sample is None else sample[0, :16].tolist())


if __name__ == "__main__":
    main()
