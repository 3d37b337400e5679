"""The granite-4.0-h-micro decode cell on the CPU: its reference's leaves
against the port's tree, its cost terms, the comparison that decides
``correct`` with the control and the faults at a test size (faults of the
mixers' recurrence too), the program's mamba2 spans in the trace and the
cell's readers."""
import contextlib

import numpy as np
import pytest
import torch

from perfbench import harness, lm_traffic, lm_weights, spec, tracing, yardstick
from perfbench.programs import lm_decode

SEED = 2**33 + 30  # larger than 32 bits hold, as a benchmark run's seed may be
CELL = "granite4_h_micro_bf16.decode64_ctx1k"
#: decode steps of a test run's window, whatever the time it takes
WINDOW_STEPS = 12
#: one period of the published pattern at tiny widths, and weights of the
#: std that gives each product of width 64 the gain 0.02 gives one of width
#: 2,048, so that rounding grows through the depth as at full size
TEST_SIZE = dict(num_hidden_layers=10, hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=2, shared_intermediate_size=96, vocab_size=256,
                 mamba_n_heads=16, mamba_d_head=8, mamba_d_state=8,
                 initializer_range=0.02 * (2048 / 64) ** 0.5)
#: a small decode mix: 4 slots, prompts of 21 tokens
SMALL_MIX = dict(slots=4, prompt_len=21, decode_budget=400, logits_every=3, logits_kept=8,
                 warmup_steps=2, trace_steps=4)
#: the limits at the test size, set as the cell's were: over three seeds
#: the bf16 program reads 0.048-0.065 on ``logit_gap`` and 0 on
#: ``served_token_gap`` here, the float8 control 0.245-0.980, the faults
#: 1.8 and more (caches unchanged, half the slots), 6.2 and more (a token
#: altered) and 0.94 and more (the mixers' recurrence broken:
#: :func:`_recurrence_fault`)
TEST_LIMITS = {"logit_gap": 0.12, "served_token_gap": 0.45}


@pytest.fixture(autouse=True)
def fixed_window(monkeypatch):
    """A window of :data:`WINDOW_STEPS` steps, on two threads, and the
    port's prefill scan in chunks of 8 (a 21-token prompt: two whole
    chunks and a short one)."""
    from repro_torch.models import mamba2

    monkeypatch.setattr(mamba2, "SSD_CHUNK", 8)
    plain = lm_decode.Loop.run

    def run(self, *, seconds=None, steps=None, **kw):
        return plain(self, steps=WINDOW_STEPS if seconds is not None else steps, **kw)

    monkeypatch.setattr(lm_decode.Loop, "run", run)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _conf(**kw):
    conf = spec.config("granite4_h_micro_bf16")
    return {**conf, "layer_types": conf["layer_types"][:10], **kw}


def _cell(conf, **mix):
    cell = spec.cell(CELL)
    return spec.Cell("trial.small", conf, {**cell.traffic, **SMALL_MIX, **mix}, cell.end_to_end,
                     cell.per_layer)


def _meta_leaves(conf):
    ref = lm_decode.load_reference(conf)
    return ref, {k: torch.empty(shape, dtype=torch.bfloat16, device="meta")
                 for k, (shape, _) in lm_weights.table(ref, conf).items()}


def test_the_configuration_is_the_ports_granite():
    from repro_torch.configs import get_config

    conf = spec.config("granite4_h_micro_bf16")
    ref = lm_decode.load_reference(conf)
    cfg = get_config(conf["arch"])
    assert cfg.replace(**ref.port_fields(conf)) == cfg  # every published width as the port's
    assert ref.pattern(conf) == ("mamba2_mlp",) * 5 + ("attn",) + ("mamba2_mlp",) * 4
    with pytest.raises(ValueError, match="no positional encoding"):
        ref.port_fields(dict(conf, position_embedding_type="rope"))
    with pytest.raises(ValueError, match="one group"):
        ref.port_fields(dict(conf, mamba_n_groups=2))


def test_the_reference_leaves_nest_into_the_ports_tree():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    conf = spec.config("granite4_h_micro_bf16")
    _, leaves = _meta_leaves(conf)
    tree = lm_weights.nest(leaves, transformer.abstract_params(get_config(conf["arch"])))
    mamba = tree["groups"]["pos0"]["mamba"]
    assert mamba["w_in"].shape == (4, 2048, 2 * 4096 + 2 * 128 + 64)
    assert mamba["conv_w"].shape == (4, 4, 4096 + 2 * 128)
    assert mamba["conv_w"].dtype == torch.float32
    assert tree["groups"]["pos5"]["attn"]["wk"].shape == (4, 2048, 8, 64)
    assert tree["groups"]["pos9"]["mlp"]["wi_gate"].shape == (4, 2048, 8192)
    with pytest.raises(ValueError, match="leaves differ"):
        lm_weights.nest({k: v for k, v in leaves.items() if "conv_b" not in k},
                        transformer.abstract_params(get_config(conf["arch"])))


def test_the_decode_cost_of_granite():
    """The published config's arithmetic: 3,191,396,096 parameters; K/V 4 x 2 x 8 x 64
    x 2 bytes a position; a state of 36 x (64 x 128 x 64 + 3 x 4,352) fp32
    values a slot; at 64 slots and about 1,100 positions 16.9 GB a step,
    59 % of it the state."""
    conf = spec.config("granite4_h_micro_bf16")
    ref, leaves = _meta_leaves(conf)
    terms = ref.cost_terms(conf)
    assert terms == {"kv_bytes_per_position": 4 * 2 * 8 * 64 * 2,
                     "state_bytes_per_slot": 77_377_536,
                     "attn_flops_per_position": 4 * 4 * 32 * 64}
    assert terms["state_bytes_per_slot"] == 36 * 4 * (64 * 128 * 64 + 3 * 4352)
    cost = yardstick.decode_cost(leaves, terms, 64, conf["vocab_size"])
    assert cost.params == 3_191_396_096 and cost.weight_bytes == 2 * cost.params
    pos = 1100
    assert cost.step_bytes(pos) == (2 * cost.params + 64 * (8192 * (pos + 1) + 2 * 77_377_536
                                                           + 4 * 100_352))
    assert cost.step_bytes(pos) == pytest.approx(16.9e9, rel=0.005)
    assert 64 * 2 * 77_377_536 / cost.step_bytes(pos) == pytest.approx(0.59, abs=0.005)
    assert cost.token_flops(pos) == 2 * cost.params + 32768 * (pos + 1)


@pytest.mark.parametrize("mode,correct", [
    ("program", True), ("control", False), ("token_altered", False),
    ("state_unchanged", False), ("half_batch", False)])
def test_a_run_is_correct_only_with_the_program(mode, correct):
    cell = _cell(_conf(**TEST_SIZE, limits=TEST_LIMITS))
    result = lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu", mode=mode)
    assert result["correct"] is correct, result["checks"]
    assert result["attempted"] > 0 and (result["failed"] == 0) is correct
    assert set(result["metrics"]) == {"tokens_per_s", "decode_step_p95_ms", "setup_s"}


def _keep_ssm(old, new):
    """``new``'s caches with every mixer's recurrent state (``"ssm"``) taken
    from ``old``."""
    if isinstance(new, dict):
        return {k: old[k] if k == "ssm" else _keep_ssm(old[k], v) for k, v in new.items()}
    return new


@contextlib.contextmanager
def _recurrence_fault(fault, monkeypatch):
    """A fault of the mixers' recurrence alone, planted in the program:
    ``ssm_unchanged`` (each step returns the recurrent states it was given,
    the conv states and K/V caches advanced), ``no_decay`` (the decay taken
    as 1) or ``no_input`` (the ``dt B x`` term dropped)."""
    from repro_torch.models import mamba2

    step = mamba2._ssm_step
    if fault == "ssm_unchanged":
        plain = lm_decode.Decoder.decode

        def decode(self, tok, caches, pos):
            logits, new = plain(self, tok, caches, pos)
            return logits, _keep_ssm(caches, new)

        monkeypatch.setattr(lm_decode.Decoder, "decode", decode)
    elif fault == "no_decay":
        monkeypatch.setattr(mamba2, "_ssm_step",
                            lambda x, b, c, dt, a, S: step(x, b, c, dt, torch.ones_like(a), S))
    else:
        monkeypatch.setattr(mamba2, "_ssm_step",
                            lambda x, b, c, dt, a, S: step(x, b, c, torch.zeros_like(dt), a, S))
    yield


@pytest.mark.parametrize("fault", ["ssm_unchanged", "no_decay", "no_input"])
def test_a_broken_recurrence_is_not_correct(fault, monkeypatch):
    """The mixers' recurrent state carries about half of each mixer's
    output (the conv's weights are ones: ``assumed``), so a decode whose
    recurrence alone is broken fails the limits; with the conv's weights
    seeded normals of std 0.02 these read 0.04-0.09, under them."""
    cell = _cell(_conf(**TEST_SIZE, limits=TEST_LIMITS))
    with _recurrence_fault(fault, monkeypatch):
        result = lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu")
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["logit_gap"]["value"] > 5 * TEST_LIMITS["logit_gap"]


def test_a_decode_one_position_on_reads_as_the_program_without_positions():
    """``pos_shift`` writes each token one cache slot on and attends over
    one slot more, left empty: with no positional encoding that moves the
    attention only by the empty slot's share of its softmax, a zero value,
    so the shifted decode reads as the program (at the cell's 1,025
    positions, a thousandth of the softmax)."""
    cell = _cell(_conf(**TEST_SIZE, limits={}))
    reads = {mode: lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu", mode=mode)["checks"]
             for mode in ("program", "pos_shift")}
    gap = {mode: c["logit_gap"]["value"] for mode, c in reads.items()}
    assert gap["pos_shift"] < TEST_LIMITS["logit_gap"]
    assert gap["pos_shift"] == pytest.approx(gap["program"], rel=0.5)


def test_the_ports_int8_weights_read_between_the_program_and_the_control():
    cell = _cell(_conf(**TEST_SIZE, limits={}))
    reads = {mode: lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu", mode=mode)["checks"]
             for mode in ("program", "int8_weights", "control")}
    gap = {mode: c["logit_gap"]["value"] for mode, c in reads.items()}
    assert gap["program"] < gap["int8_weights"] < gap["control"]


def _traced(steps=3):
    """A CPU profile of ``steps`` decode steps of the test-size program."""
    conf = _conf(**TEST_SIZE)
    ref = lm_decode.load_reference(conf)
    mix = {**spec.traffic("decode64_ctx1k"), **SMALL_MIX}
    seeds = lm_traffic.seeds(SEED)
    rows = lm_traffic.prompts(mix, conf["vocab_size"], seeds.prompts)
    weights = lm_weights.draw(ref, conf, seeds.weights, "cpu")
    cost = yardstick.decode_cost(weights, ref.cost_terms(conf), mix["slots"],
                                 conf["vocab_size"])
    decoder = lm_decode.Decoder(conf, ref, weights, mix, "cpu", "program")
    with torch.inference_mode():
        logits, caches = decoder.prefill(torch.from_numpy(rows))
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        loop = lm_decode.Loop(decoder, first, caches, mix, conf["vocab_size"], 0,
                              torch.device("cpu"))
        window, trace = lm_decode._traced_segment(loop, steps, False)
    return lm_decode.Run(spec.cell(CELL), 1.0, window, cost, trace, window.positions)


def test_the_mamba2_spans_reach_the_trace():
    """Each traced step holds a ``mamba2`` and a ``mamba2.scan`` span for
    each of the period's 9 mixers, an ``attn`` span and 10 ``mlp`` spans,
    with no ``program_spans()`` scope (an eager step: on the CPU the server
    replays no graph)."""
    run = _traced(steps=3)
    spans = run.trace.spans
    calls = {k[len(tracing.PROGRAM_PREFIX):]: v.calls for k, v in spans.items()}
    assert calls == {"mamba2": 27, "mamba2.scan": 27, "attn": 3, "mlp": 30}
    assert spans["repro_torch.mamba2"].host_s >= spans["repro_torch.mamba2.scan"].host_s > 0


def test_the_readers_on_a_synthetic_trace():
    """Two traced steps of a replayed graph, which holds no program span:
    the device busy 60 of 64 ms, 30 ms a step, 6.25 % idle, and the
    roofline the two steps' least time over those 60 ms."""
    conf = spec.config("granite4_h_micro_bf16")
    ref, leaves = _meta_leaves(conf)
    cost = yardstick.decode_cost(leaves, ref.cost_terms(conf), 64, conf["vocab_size"])
    ops = [tracing.DeviceOp("void at::native::elementwise_kernel", 0, 30_000_000),
           tracing.DeviceOp("void at::native::elementwise_kernel", 32_000_000, 30_000_000)]
    trace = tracing.Trace(blocks=2, window_s=0.064, device_ops=ops, busy_s=0.06, gaps=[])
    window = lm_decode.DecodeWindow(2, 64, 0.064, [0.032] * 2, [0.001] * 2, [1024, 1025],
                                    [0, 0], np.zeros((2, 64), np.int64), {})
    run = lm_decode.Run(spec.cell(CELL), 1.0, window, cost, trace, [1024, 1025])
    got = {k: v["value"] for k, v in harness.read_metrics(run, spec.cell(CELL).per_layer).items()}
    bound = cost.step_bound_s(1024) + cost.step_bound_s(1025)
    assert got["decode_device_ms_per_step"] == pytest.approx(30.0)
    assert got["decode_idle_share"] == pytest.approx(6.25)
    assert got["decode_hbm_roofline"] == pytest.approx(100.0 * bound / 0.06)
    assert 0 < got["decode_hbm_roofline"] < 100
    assert got["decode_issue_ms_per_step"] == pytest.approx(1.0)


def test_the_cell_reports_the_lm_metrics_and_the_mixers_host_time():
    """The cell reports the LM cells' metrics, and no mixers' host time: on
    the card its step replays as one CUDA graph, whose mixers issue no
    span."""
    cell = spec.cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"tokens_per_s", "decode_step_p95_ms",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in spec.cell("phi4_mini_bf16.decode_ctx3k").per_layer} == {
        "decode_issue_ms_per_step", "decode_device_ms_per_step", "decode_hbm_roofline",
        "decode_mfu", "decode_idle_share"}
    assert cell.chips == 1 and lm_traffic.max_seq(cell.traffic) == 2048


def test_the_reference_computes_without_tf32(monkeypatch):
    conf = _conf(**TEST_SIZE, torch_dtype="float32")
    ref = lm_decode.load_reference(conf)
    weights = lm_weights.draw(ref, conf, 5, "cpu")
    seen = []
    plain = ref._matmul

    def matmul(a, w, fp8):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return plain(a, w, fp8)

    monkeypatch.setattr(ref, "_matmul", matmul)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ref.hidden(weights, conf, torch.zeros((1, 4), dtype=torch.long), 0)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
