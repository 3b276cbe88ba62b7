"""The paper's technique applied to the LM substrate: K-Means over pooled
document representations of a transformer (embedding-space clustering —
data curation / semantic dedup style), using the same assignment kernel.

    PYTHONPATH=src python -m repro_torch.examples.embedding_clustering
    PYTHONPATH=src python -m repro_torch.examples.embedding_clustering \\
        --device cpu

The counterpart of the reference's ``examples/embedding_clustering.py``,
with its computation kept: a forward pass over random tokens (its logits
are unused, as there), the documents' token embeddings mean-pooled and
L2-normalised, and K-Means (k-means++ seeding) over them in fp32.  On the
card the forward launches the flash attention kernel and the fit the
assignment kernel.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import kmeans
from repro_torch.models import lm
from repro_torch.runtime import backend

K = 4
B, S = 32, 32


def init_model(cfg: ModelConfig, device, seed: int = 0) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.init_params(gen, cfg, device=device)


def random_tokens(cfg: ModelConfig, batch: int, seq: int, device,
                  seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=gen).to(device)


def embed_documents(params: dict, tokens: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled (B, d_model) fp32 points, the forward's logits).

    The pooled representation is the reference's: the token embeddings
    mean-pooled and L2-normalised (``+ 1e-6``), in the model's dtype, then
    cast to fp32.
    """
    with torch.no_grad():
        logits, _ = lm.forward(params, tokens, cfg)
        emb = params["embed"][tokens].mean(dim=1)
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                     + 1e-6)
    return emb.float(), logits


def cluster(emb: torch.Tensor, k: int = K, seed: int = 2, *,
            use_kernel: bool = True) -> kmeans.KMeansResult:
    cfg = kmeans.KMeansConfig(k=k, init="kmeans++", use_kernel=use_kernel)
    return kmeans.fit(seed, emb, cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = backend.load(args.device).device
    cfg = get_smoke_config("olmo-1b")
    params = init_model(cfg, dev)

    # embed a batch of synthetic documents and pool them
    toks = random_tokens(cfg, B, S, dev)
    emb, logits = embed_documents(params, toks, cfg)

    res = cluster(emb)
    labels = res.labels.long().cpu()
    print(f"clustered {B} documents into {K} groups: "
          f"sizes={torch.bincount(labels, minlength=K).tolist()}, "
          f"inertia={float(res.inertia):.4f}, "
          f"iters={int(res.iterations)}")
    return {"emb": emb, "logits": logits, "result": res}


if __name__ == "__main__":
    main()
