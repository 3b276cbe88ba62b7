"""The jamba2-mini cell: its files found by name, its result line on the
host at the port's smoke widths, its fp8 control over a limit, and its
four readers on a hand-made trace and on none."""

import pytest

from portbench import jamba_work, readings, run, serving, spec, tracing
from portbench.tests.sizes import small_config
from portbench.tests.test_portbench_imports import _tops

CELL, CONFIG = "jamba2-mini.serve", "jamba2-mini"
READERS = ("jamba_mfu", "moe_roofline", "prefill_ms", "decode_token_ms")


def test_the_configuration_keeps_the_published_keys():
    """Every published key as the source states it, but those cut and
    listed in ``reduced``; the port's config agrees with them."""
    bench = spec.benchmark()
    entry = [c for c in bench["configs"] if c["name"] == CONFIG][0]
    cfg = spec.config(bench, CONFIG)
    changed = {k for k, v in cfg["source_settings"].items() if cfg[k] != v}
    assert changed == set(entry["reduced"]) == {"num_hidden_layers"}
    port = spec.generator(cfg["data"]["generator"]).model_config(cfg)
    assert (port.n_layers, port.d_model, port.vocab) == (8, 4096, 65536)
    for m in bench["per_layer"]:
        if m["name"] in READERS + ("device_idle",):
            assert m["workloads"][-1] == CELL


def test_a_config_the_port_disagrees_with_is_refused():
    cfg = dict(spec.config(spec.benchmark(), CONFIG), mamba_d_state=8)
    with pytest.raises(ValueError, match="differs"):
        spec.generator(cfg["data"]["generator"]).model_config(cfg)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_on_the_host(trace):
    r = run.run_cell(CELL, 2**31 + 5, 0.2, trace, device="cpu",
                     config=small_config(CONFIG))
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["checks"]) == {"far_share", "gap_rms"}
    assert all(c["value"] < 1e-4 for c in r["checks"].values())
    if trace:   # no card, no device numbers
        assert r["metrics"] == {}


def test_the_reference_imports_nothing_of_the_program():
    tops = _tops("""
import torch
from portbench.reference import jamba
from portbench.tests.sizes import small_config
cfg = small_config("jamba2-mini")
w = {"model.embed_tokens.weight": torch.randn(512, 64),
     "model.final_layernorm.weight": torch.ones(64),
     "lm_head.weight": torch.randn(512, 64)}
jamba.logits(w, torch.zeros((1, 3), dtype=torch.long),
             dict(cfg, num_hidden_layers=0), [2], "fp8")
""")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_weights_reach_the_program_as_views_of_the_drawn_ones():
    """The port's tree holds the tensors drawn in Hugging Face's layout,
    not copies: one allocation serves the program and the reference."""
    cfg = small_config(CONFIG)
    gen = spec.generator(cfg["data"]["generator"])
    import torch
    w = gen.shared(cfg, torch.Generator().manual_seed(3))
    hf, tree = w["hf"], w["program"]
    drawn = {t.untyped_storage().data_ptr() for t in hf.values()}
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(tree)
    assert {t.untyped_storage().data_ptr() for t in leaves} <= drawn
    up = tree["layers"]["sub_1"]["moe"]["w_up"][0, 3]
    assert torch.equal(
        up, hf["model.layers.1.feed_forward.experts.3.up_proj.weight"].t())


def test_a_leaf_the_port_declares_otherwise_is_refused():
    cfg = small_config(CONFIG)
    gen = spec.generator(cfg["data"]["generator"])
    import torch
    w = gen.draw(cfg, torch.Generator().manual_seed(3))
    name = "model.layers.0.mamba.dt_layernorm.weight"
    w[name] = w[name][:-1]
    with pytest.raises(ValueError, match="as the port declares"):
        gen.program(w, cfg, gen.model_config(cfg))


def test_fp8_control_breaks_a_limit_and_the_program_none():
    limits = {k: v["limit"]
              for k, v in spec.limits(CELL)["numbers"].items()}
    for r in readings.readings(CELL, [3], [3, 4], device="cpu",
                               config=small_config(CONFIG)):
        over = [k for k, lim in limits.items() if r["numbers"][k] > lim]
        assert bool(over) == (r["side"] == "control"), r


class _Ctx:
    def __init__(self, trace, config) -> None:
        self.trace, self.config, self.jobs = trace, config, [None, None]


def _trace():
    """Two jobs: a prefill span of 100 us with two expert kernels inside
    (one overlapping the span's end), one outside in the decode."""
    grouped = ("_ZN7cutlass13device_kernelINS_4gemm6kernel13GemmUniversal"
               "INS5_17GroupProblemShapeIN4cute5tupleIJiiiEEEEE")
    device = [
        ("void at::cuda::detail::prepare_grouped_gemm_data<float>()", 5, 6),
        (grouped, 10, 30),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 30, 60),
        (grouped, 90, 120),
        (grouped, 150, 160),
    ]
    host = [("repro_torch.lm.prefill", 0, 100),
            ("repro_torch.lm.decode", 100, 180),
            ("repro_torch.lm.prefill", 200, 300),
            ("repro_torch.lm.decode", 300, 380)]
    return tracing.Trace(device, host, 0.0, 400.0)


PAIRS = (16384 + 64) * 2 * 4


def _counters(monkeypatch, table):
    monkeypatch.setattr(serving, "count", lambda name: table.get(name))


def test_readers_on_a_hand_made_trace(monkeypatch):
    cfg = spec.config(spec.benchmark(), CONFIG)
    _counters(monkeypatch, {"lm.prefill_tokens": 16384,
                            "lm.decode_tokens": 64,
                            "moe.routed_pairs": PAIRS})
    ctx = _Ctx(_trace(), cfg)
    got = {name: spec.reader(name).read(ctx) for name in READERS}
    # device time inside the prefill spans, 1 + 50 + 10 us, over 2 jobs
    assert got["prefill_ms"] == pytest.approx(0.061 / 2)
    # inside the decode spans 20 + 10 us; 64 decoded tokens of a batch
    # of 2: 32 steps
    assert got["decode_token_ms"] == pytest.approx(0.030 / 32)
    assert got["jamba_mfu"] == pytest.approx(
        100 * jamba_work.job_flops(cfg, 16384, 64, PAIRS)
        / (400e-6 * 989e12))
    # the expert kernels inside prefill spans: 1 + 20 + 10 us
    assert got["moe_roofline"] == pytest.approx(
        100 * jamba_work.routed_prefill_flops(cfg, 16384) / (31e-6 * 989e12))


def test_readers_read_nothing_without_a_trace_or_counters(monkeypatch):
    cfg = spec.config(spec.benchmark(), CONFIG)
    empty = _Ctx(tracing.Trace([], [], 0.0, 0.0), cfg)
    _counters(monkeypatch, {"lm.prefill_tokens": 16384,
                            "lm.decode_tokens": 64,
                            "moe.routed_pairs": PAIRS})
    assert all(spec.reader(n).read(empty) is None for n in READERS)
    _counters(monkeypatch, {})
    counted = {n: spec.reader(n).read(_Ctx(_trace(), cfg)) for n in READERS}
    assert counted["jamba_mfu"] is None and counted["moe_roofline"] is None
    assert counted["decode_token_ms"] is None


def test_work_counts_follow_the_published_widths():
    cfg = spec.config(spec.benchmark(), CONFIG)
    # 2.89 B active parameters a token in the period, 2 operations each:
    # the rest of the layers and a token's 2 routed pairs in 4 MoE layers
    assert jamba_work.token_flops(cfg) + 2 * 4 * jamba_work.expert_pair_flops(
        cfg) == 2 * 2_892_201_984
    assert jamba_work.moe_layers(cfg) == 4
    assert jamba_work.routed_prefill_flops(cfg, 8192) == (
        8192 * 2 * 4 * 6 * 4096 * 14336)
    # dropless: the counted pairs are every token's top-2 in every MoE
    # layer, so the counter adds what the token counts imply
    assert jamba_work.job_flops(cfg, 8192, 32, (8192 + 32) * 2 * 4) == (
        jamba_work.job_flops(cfg, 8192, 32, 0)
        + (8192 + 32) * 2 * 4 * jamba_work.expert_pair_flops(cfg))
