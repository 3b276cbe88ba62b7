"""The port's LM serving driver on the CPU: ``serve_batch`` and its CLI.

On the card, ``chip_smoke.py`` drives the same entry point at the full width
of every arch (OLMo-1B in phase 3c, the other six families in 3e) and checks
that every attention layer of a prefill launched the flash kernel."""

import pytest
import torch

from repro_torch.configs import ARCH_NAMES
from repro_torch.core.cancellation import CancellationToken
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import serve


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_batch_on_cpu(arch):
    out = serve.serve_batch(arch=arch, smoke=True, batch=3, prompt_len=7,
                            gen=5, device="cpu")
    assert set(out) >= {"generated", "prefill_s", "decode_s", "tokens_per_s"}
    gen = out["generated"]
    assert gen.shape == (3, 5) and gen.dtype == torch.int32
    assert int(gen.min()) >= 0 and int(gen.max()) < 512
    assert out["logits_finite"]
    assert out["prefill_logits"].shape[:2] == (3, 1)
    assert out["tokens_per_s"] > 0
    # greedy decode on the same seed gives the same tokens
    again = serve.serve_batch(arch=arch, smoke=True, batch=3, prompt_len=7,
                              gen=5, device="cpu")
    assert torch.equal(again["generated"], gen)


def test_serve_batch_samples_with_temperature():
    kw = dict(arch="olmo-1b", smoke=True, batch=2, prompt_len=4, gen=6,
              device="cpu")
    a = serve.serve_batch(temperature=1.0, seed=1, **kw)["generated"]
    b = serve.serve_batch(temperature=1.0, seed=1, **kw)["generated"]
    c = serve.serve_batch(temperature=1.0, seed=2, **kw)["generated"]
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert not torch.equal(a, c)


def test_serve_batch_stops_on_cancel():
    tok = CancellationToken()
    tok.cancel()
    out = serve.serve_batch(arch="olmo-1b", smoke=True, batch=2, prompt_len=4,
                            gen=6, token=tok, device="cpu")
    assert out["generated"] is None and out["tokens_per_s"] == 0


def test_serve_batch_runs_no_kernel_on_cpu():
    before = attn_ops.flash_attention.launches
    serve.serve_batch(arch="olmo-1b", smoke=True, batch=1, prompt_len=4,
                      gen=2, device="cpu")
    assert attn_ops.flash_attention.launches == before


def test_serve_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_batch(arch="olmo-1b", smoke=True, batch=1, prompt_len=4,
                          gen=1)


def test_cli_takes_device_cpu(capsys):
    serve.main(["--arch", "glm4-9b", "--smoke", "--batch", "2",
                "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out and "sample:" in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "olmo-1b", "--device", "tpu"])


@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-medium",
                                  "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_cli_serves_every_family_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu``: prefill, greedy decode, a sample; no flash launch on the host."""
    before = attn_ops.flash_attention.launches
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "9", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out and "sample:" in out
    assert attn_ops.flash_attention.launches == before
