"""The Mamba mixer's selective scan (``kernels/ssm``): the plain model of
``csrc/selective_scan.cu``'s token order against the doubling scan and the
reference's associative scan, the wrapper's checks, and the rule by which
``models/mamba.py`` routes a prefill to the kernel.

Marked ``cuda`` (skipped without a card): the kernel against its plain
model at the smoke widths and at the jamba2-mini cell's shape, two
launches' bits, ``mamba_block`` and the decode chained after it, and one
launch a Mamba layer of a prefill.  JAX is imported only inside the test
that needs it, so on the card: ``PYTHONPATH=src python -m pytest
--noconftest tests/test_torch_selective_scan.py -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm import ops, ref
from repro_torch.models import lm, mamba
from repro_torch.runtime import spans

RTOL, ATOL = 1e-4, 1e-5   # the mixer's tolerance (tests/test_torch_mamba.py)
ARCH = "falcon-mamba-7b"


def _close(got, want, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _inputs(bsz, length, di, st, seed, dtype=torch.float32, device="cpu"):
    """Scan inputs as ``_ssm_coeffs`` makes them: dt after a softplus, A
    the S4D init's -(1..st), x, B, C and D of order 1."""
    g = torch.Generator().manual_seed(seed)
    xc = torch.randn(bsz, length, di, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, length, di, generator=g) - 3.0)
    b = torch.randn(bsz, length, st, generator=g)
    c = torch.randn(bsz, length, st, generator=g)
    a = -torch.arange(1, st + 1, dtype=torch.float32).expand(di, st)
    a = (a * (1 + 0.1 * torch.rand(di, st, generator=g))).contiguous()
    d = 1 + 0.1 * torch.randn(di, generator=g)
    return tuple(t.to(device) for t in (xc, dt, b, c, a, d))


def _mixer(arch, st, seed=0):
    """A smoke config with ``st`` states and its first Mamba layer's
    parameters."""
    cfg = dataclasses.replace(get_smoke_config(arch), ssm_state=st)
    params = lm.init_params(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")
    for sub in params["layers"].values():
        if "mamba" in sub:
            return cfg, {k: v[0] for k, v in sub["mamba"].items()}
    raise KeyError("mamba")


def _x(cfg, bsz, length, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(bsz, length, cfg.d_model, generator=g)


# -- the plain model on the host ---------------------------------------------


@pytest.mark.parametrize("length", [1, 7, 128, 1000])
@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("st", [4, 16])
def test_kernel_route_matches_the_doubling_scan(monkeypatch, st, bsz,
                                                length):
    """mamba_block through the kernel's route (its plain model on the
    host) against the chunked doubling scan (``_chunk_body``, chunks of 8
    that 7 and 1000 do not fill): outputs, conv state and the last
    states."""
    cfg, params = _mixer(ARCH, st)
    x = _x(cfg, bsz, length, seed=st + bsz + length)
    with torch.no_grad():
        want = mamba.mamba_block(params, x, cfg, return_state=True)
        monkeypatch.setattr(mamba, "_takes_scan_kernel", lambda *_: True)
        got = mamba.mamba_block(params, x, cfg, return_state=True)
    assert got[2].shape == (bsz, cfg.d_inner, st)
    assert got[2].dtype == torch.float32
    _close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    _close(got[2], want[2])


def test_kernel_route_with_the_published_norms(monkeypatch):
    """jamba2-mini's dt/B/C norms reach the scan as the doubling scan
    reads them."""
    cfg, params = _mixer("jamba2-mini", 4)
    x = _x(cfg, 2, 37, seed=5)
    with torch.no_grad():
        want = mamba.mamba_block(params, x, cfg, return_state=True)
        monkeypatch.setattr(mamba, "_takes_scan_kernel", lambda *_: True)
        got = mamba.mamba_block(params, x, cfg, return_state=True)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("length", [1, 7, 128, 1000])
@pytest.mark.parametrize("st", [4, 16])
def test_plain_model_matches_the_reference_scan(st, length):
    """The plain model against the reference's associative scan
    (``repro.models.mamba._scan_chunk``) on the same a, bx and C."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import mamba as jmamba

    xc, dt, b, c, a, d = _inputs(2, length, 24, st, seed=length + st)
    y, h = ref.selective_scan_ref(xc, dt, b, c, a, d)
    at = torch.exp(dt[..., None] * a)
    bx = (dt * xc)[..., None] * b[..., None, :]

    def tm(t):   # (B, L, ...) -> (L, B, ...)
        return jnp.asarray(t.transpose(0, 1).numpy())

    hs = jmamba._scan_chunk(jnp.zeros((2, 24, st)), tm(at), tm(bx))
    jy = jnp.einsum("lbis,lbs->bli", hs, tm(c)) + d.numpy() * xc.numpy()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hs[-1]), rtol=RTOL,
                               atol=ATOL)


def test_plain_model_sums_states_in_the_kernels_order():
    """y's sum over states is each lane's states in order, then the xor
    tree of the four lanes, spelled out one addition at a time."""
    xc, dt, b, c, a, d = _inputs(1, 5, 3, 10, seed=9)
    y, _h = ref.selective_scan_ref(xc, dt, b, c, a, d)
    ns = ref.states_a_lane(10)
    assert ns == 3
    f32 = np.float32
    h = np.zeros((3, 10), f32)
    for t in range(5):
        for i in range(3):
            dx = f32(dt[0, t, i].numpy() * xc[0, t, i].numpy())
            for s in range(10):
                at = np.exp(dt[0, t, i].numpy() * a[i, s].numpy())
                bx = f32(dx * b[0, t, s].numpy())
                h[i, s] = f32(f32(at * h[i, s]) + bx)
            q = []
            for lane in range(4):
                acc = None
                for s in range(lane * ns, min(lane * ns + ns, 10)):
                    p = f32(h[i, s] * c[0, t, s].numpy())
                    acc = p if acc is None else f32(acc + p)
                q.append(f32(0) if acc is None else acc)
            want = f32(f32(f32(q[0] + q[1]) + f32(q[2] + q[3]))
                       + f32(d[i].numpy() * xc[0, t, i].numpy()))
            # np.exp and torch.exp may differ in the last bit
            assert abs(float(y[0, t, i]) - float(want)) <= \
                1e-6 * max(1.0, abs(float(want)))


def test_the_wrapper_on_the_host_is_the_plain_model():
    args = _inputs(2, 9, 16, 16, seed=2)
    before = ops.selective_scan.launches
    y, h = ops.selective_scan(*args)
    ry, rh = ref.selective_scan_ref(*args)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    assert ops.selective_scan.launches == before


# -- the wrapper's checks ----------------------------------------------------


def _bad(field, value):
    args = dict(zip("xc dt b c a d".split(), _inputs(2, 6, 8, 4, seed=1)))
    args[field] = value(args[field])
    return args


@pytest.mark.parametrize("field,value,err", [
    ("xc", lambda t: t.double(), TypeError),
    ("xc", lambda t: t.half(), TypeError),
    ("dt", lambda t: t.bfloat16(), TypeError),
    ("b", lambda t: t.double(), TypeError),
    ("a", lambda t: t.bfloat16(), TypeError),
    ("d", lambda t: t.half(), TypeError),
    ("xc", lambda t: t[0], ValueError),
    ("dt", lambda t: t[:, :5], ValueError),
    ("b", lambda t: t[..., :3], ValueError),
    ("c", lambda t: t[:1], ValueError),
    ("a", lambda t: t[:7], ValueError),
    ("d", lambda t: t[:7], ValueError),
    ("xc", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
    ("dt", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
    ("b", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("a", lambda t: t.t().contiguous().t(), ValueError),
    ("c", lambda t: t.to("meta"), ValueError),
])
def test_the_wrapper_refuses_what_it_does_not_take(field, value, err):
    with pytest.raises(err):
        ops.selective_scan(**_bad(field, value))


@pytest.mark.parametrize("st", [17, 32])
def test_the_wrapper_refuses_wide_states(st):
    with pytest.raises(ValueError, match="d_state"):
        ops.selective_scan(*_inputs(1, 3, 4, st, seed=st))


def test_the_wrapper_refuses_an_empty_sequence():
    with pytest.raises(ValueError, match="L >= 1"):
        ops.selective_scan(*_inputs(2, 0, 8, 4, seed=0))


def test_the_wrapper_refuses_the_meta_device():
    args = [t.to("meta") for t in _inputs(1, 3, 4, 4, seed=0)]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.selective_scan(*args)


class _Form:
    """A stand-in library whose ``selective_scan_form`` reports ``form``."""

    def __init__(self, form):
        self.form = form

    def selective_scan_form(self, out):
        out[:] = self.form


@pytest.mark.parametrize("form,holds", [
    ((ref.SCAN_THREADS, ref.SCAN_LANES, ref.SCAN_MAX_STATE), True),
    ((256, ref.SCAN_LANES, ref.SCAN_MAX_STATE), False),
    ((ref.SCAN_THREADS, 8, ref.SCAN_MAX_STATE), False),
    ((ref.SCAN_THREADS, ref.SCAN_LANES, 32), False),
])
def test_the_library_form_is_held_to_the_plain_model(monkeypatch, form,
                                                     holds):
    lib = _Form(form)
    monkeypatch.setattr(ops._build, "library", lambda *_a, **_k: lib)
    monkeypatch.setattr(ops, "_checked", False)
    if holds:
        assert ops._lib() is lib and ops._checked
    else:
        with pytest.raises(RuntimeError, match="selective_scan_form"):
            ops._lib()
        assert not ops._checked


# -- routing -----------------------------------------------------------------


@dataclasses.dataclass
class _X:
    is_cuda: bool


@pytest.mark.parametrize("is_cuda,grad,st,takes", [
    (True, False, 16, True),      # a prefill on the card
    (True, False, 4, True),       # the smoke configs
    (True, True, 16, False),      # training: the kernel has no backward
    (False, False, 16, False),    # the host (and the meta device)
    (True, False, 17, False),     # wider than the kernel's registers
])
def test_the_route_rule(is_cuda, grad, st, takes):
    cfg = dataclasses.replace(get_smoke_config(ARCH), ssm_state=st)
    with torch.set_grad_enabled(grad):
        assert mamba._takes_scan_kernel(_X(is_cuda), cfg) is takes


def test_the_meta_device_keeps_the_doubling_scan():
    cfg, params = _mixer(ARCH, 4)
    meta = {k: v.to("meta") for k, v in params.items()}
    before = ops.selective_scan.launches
    with torch.no_grad():
        out = mamba.mamba_block(meta, _x(cfg, 2, 13, 0).to("meta"), cfg,
                                return_state=True)
    assert out[0].shape == (2, 13, cfg.d_model) and out[0].is_meta
    assert ops.selective_scan.launches == before


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
def test_no_launch_on_the_host(grad):
    """On the host, without autograd and under it, the mixer keeps the
    doubling scan: no launch, and the counter reads 0 under a profiler."""
    cfg, params = _mixer(ARCH, 4)
    x = _x(cfg, 2, 13, 1).requires_grad_(grad)
    before = ops.selective_scan.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.set_grad_enabled(grad):
            out = mamba.mamba_block(params, x, cfg)
        spans.count("stretch", 0)   # opens this stretch's table
    if grad:
        out.sum().backward()
        assert x.grad is not None
    assert ops.selective_scan.launches == before
    assert spans.counts().get("selective_scan.launches", 0) == 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.runtime import backend

    backend.load("cuda")  # fp32 matmul at "highest"
    return torch.device("cuda")


# the smoke widths (d_inner 128, d_state 4 or 16; lengths around a token
# group and a block of channels), a d_inner that is no multiple of a
# block's 32 channels, and the jamba2-mini cell's shape
CARD_CASES = [(2, 13, 128, 4, torch.float32), (2, 128, 128, 16,
                                               torch.float32),
              (1, 1, 128, 16, torch.bfloat16), (2, 37, 100, 6,
                                                torch.bfloat16),
              (2, 4096, 8192, 16, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,length,di,st,dtype", CARD_CASES)
def test_kernel_matches_the_plain_model(card, bsz, length, di, st, dtype):
    """The kernel against its plain model on the card, within the mixer's
    tolerance; two launches bit for bit; one launch counted a call."""
    args = _inputs(bsz, length, di, st, seed=length + di, dtype=dtype,
                   device=card)
    before = ops.selective_scan.launches
    y, h = ops.selective_scan(*args)
    y2, h2 = ops.selective_scan(*args)
    ry, rh = ref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    _close(y, ry)
    _close(h, rh)


@pytest.mark.cuda
@pytest.mark.parametrize("prompt", [10, 2, 300])
def test_mamba_block_on_the_card_takes_the_kernel(card, prompt):
    """mamba_block(return_state=True) on the card: one launch without
    autograd, none under it; the kernel's outputs and states against the
    doubling scan's on the host; then decode chained after the prefill,
    card against host, and against the block over the whole sequence."""
    cfg, host = _mixer(ARCH, 16)
    dev = {k: v.to(card) for k, v in host.items()}
    x = _x(cfg, 2, prompt + 5, seed=prompt)
    before = ops.selective_scan.launches
    with torch.enable_grad():
        mamba.mamba_block(dev, x[:, :prompt].to(card), cfg)
    assert ops.selective_scan.launches == before
    with torch.no_grad():
        got = mamba.mamba_block(dev, x[:, :prompt].to(card), cfg,
                                return_state=True)
        want = mamba.mamba_block(host, x[:, :prompt], cfg, return_state=True)
        full = mamba.mamba_block(host, x, cfg)
    assert ops.selective_scan.launches == before + 1
    for a, b in zip(got, want):
        _close(a.cpu(), b)
    _yc, conv_c, ssm_c = got
    _yh, conv_h, ssm_h = want
    with torch.no_grad():
        for t in range(prompt, prompt + 5):
            yh, conv_h, ssm_h = mamba.mamba_decode_step(
                host, x[:, t:t + 1], cfg, conv_h, ssm_h)
            yc, conv_c, ssm_c = mamba.mamba_decode_step(
                dev, x[:, t:t + 1].to(card), cfg, conv_c, ssm_c)
            for a, b in ((yc, yh), (conv_c, conv_h), (ssm_c, ssm_h)):
                _close(a.cpu(), b)
            _close(yc[:, 0].cpu(), full[:, t])
    assert ops.selective_scan.launches == before + 1


@pytest.mark.cuda
def test_prefill_launches_once_a_mamba_layer(card):
    """jamba2-mini's smoke prefill (one period: 7 Mamba layers) launches
    the kernel 7 times, the counter under a profiler reads the same, and
    its logits match the host's."""
    cfg = get_smoke_config("jamba2-mini")
    host = lm.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    from repro_torch.tree import tree_map

    dev = tree_map(lambda t: t.to(card), host)
    n_mamba = cfg.n_groups * sum(m == "mamba" for m, _ff in cfg.pattern)
    assert n_mamba == 7
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    before = ops.selective_scan.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        logits, _cache = lm.prefill_step(dev, toks.to(card), cfg, max_seq=28)
        torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + n_mamba
    assert spans.counts()["selective_scan.launches"] == n_mamba
    want, _ = lm.prefill_step(host, toks, cfg, max_seq=28)
    assert ops.selective_scan.launches == before + n_mamba
    h, c = want[..., :cfg.vocab], logits.cpu()[..., :cfg.vocab]
    assert float((h - c).abs().max()) <= 1e-4 * float(h.abs().max())
