"""A Jamba model served greedily, against the reference's full forward.

For each sampled job the reference (``portbench/reference/jamba.py``),
on the weights in Hugging Face's layout (``shared["hf"]``, from
``portbench/generators/jamba.py``), runs the whole causal forward in
float32 over the job's prompts followed by the tokens the program
generated (teacher-forced), and gives the logits at the positions the
program kept: the prompt's last and each decoded one.  Logits are
compared, never tokens: with random weights the largest logit changes on
rounding.  A position's gap (:func:`position_gaps`) is max |program -
reference| over its max |reference logit|.  Two numbers:

- ``far_share``: the share of the compared positions whose gap exceeds
  ``FAR`` (0.05);
- ``gap_rms``: the root mean square of program - reference over that of
  the reference, over every compared logit.

Not the largest gap: where two experts' router weights nearly tie at a
position, bf16 rounding picks the other one of them as the float32
reference would not, a different expert's output is added, and that
position's gap reads 0.05-0.11 in a sound run, against 0.011-0.03 at
positions routed alike, and 0.10-0.24 at every position of the fp8
control; a sound job so routes 2-8 of its 34 compared positions
otherwise (PERF.md).

The control is the reference with e4m3 inputs to every product, the
precision below the configuration's bf16, against the float32 reference
on the same sequence: the prompts and a continuation drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import inputs
from portbench.reference import jamba as ref_jamba

# The published keys the smoke config of the port's arch has, with the
# host tests' batch.
SMALL = {
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_experts": 4, "mamba_d_state": 4,
    "mamba_dt_rank": 8, "vocab_size": 512, "dtype": "float32",
    "batch": 2, "prompt_len": 16, "gen": 4, "smoke": True,
}


# A position's gap above which it counts in ``far_share``.
FAR = 0.05


def position_gaps(program: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, positions, vocab) logits against the reference's: each
    position's max |program - reference| over its max |reference|."""
    diff = (program.float() - ref).abs()
    return diff.amax(-1) / ref.abs().amax(-1)


def numbers(program: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """(B, positions, vocab) logits against the reference's."""
    diff = program.float() - ref
    return {
        "far_share": float((position_gaps(program, ref) > FAR).float()
                           .mean()),
        "gap_rms": float((diff.square().mean() / ref.square().mean()).sqrt()),
    }


def positions(config: dict) -> range:
    p = config["prompt_len"]
    return range(p - 1, p + config["gen"])


def small(config: dict) -> dict:
    """The configuration at the port's smoke widths, float32, one period,
    2 prompts of 16 tokens and 4 decoded."""
    return dict(config, **SMALL)


def control(config: dict, data: List[torch.Tensor], seed: int,
            shared=None) -> Dict[str, float]:
    """The numbers of the fp8 reference put in the program's place, on
    prompt set 0 and a continuation drawn from (seed)."""
    prompts = data[0]
    gen = inputs.generator(seed, inputs.INIT, 0, prompts.device)
    more = torch.randint(0, config["vocab_size"],
                         (prompts.shape[0], config["gen"]), generator=gen,
                         device=prompts.device)
    seq = torch.cat([prompts, more], dim=1)
    ref = ref_jamba.logits(shared["hf"], seq, config, positions(config))
    low = ref_jamba.logits(shared["hf"], seq, config, positions(config),
                           "fp8")
    return numbers(low, ref)


def check(entry, config: dict, data: List[torch.Tensor], seed: int,
          sampled) -> List[Dict[str, float]]:
    per_job = []
    for job in sampled:
        prompts = data[job.dataset]
        answer = job.answer
        seq = torch.cat([prompts, answer["tokens"].to(prompts)], dim=1)
        ref = ref_jamba.logits(entry.shared["hf"], seq, config,
                               positions(config))
        per_job.append(numbers(answer["logits"].to(ref.device), ref))
    return per_job
