"""The LM decode cell on the CPU: its reference against the port, its
traffic and weights, the comparison that decides ``correct`` with the
controls and the faults planted under the timed path, its readers, and a
trial cell built from files of its own, as the next architecture's cell
would be."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness, lm_traffic, lm_weights, spec, tracing, yardstick
from perfbench.programs import lm_decode

SEED = 2**33 + 29  # larger than 32 bits hold, as the driver's seeds are
CELL = "phi4_mini_bf16.decode_ctx3k"
#: phi4_mini's smoke widths (``ArchConfig.smoke``) in the file's keys
SMOKE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=96, vocab_size=256)
#: a small decode mix: 4 slots, prompts of 12 tokens
SMALL_MIX = dict(slots=4, prompt_len=12, decode_budget=400, logits_every=3, logits_kept=8,
                 warmup_steps=2, trace_steps=4)


#: decode steps of a test run's window, whatever the time it takes
WINDOW_STEPS = 12


@pytest.fixture(autouse=True)
def fixed_window(monkeypatch):
    """A window of :data:`WINDOW_STEPS` steps in place of one of a length
    in seconds, so that a run here judges the same rows however loaded the
    CPU is, on two threads, so that it loads the CPU little."""
    plain = lm_decode.Loop.run

    def run(self, *, seconds=None, steps=None, **kw):
        return plain(self, steps=WINDOW_STEPS if seconds is not None else steps, **kw)

    monkeypatch.setattr(lm_decode.Loop, "run", run)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _conf(**kw):
    return {**spec.config("phi4_mini_bf16"), **kw}


def _cell(conf, **mix):
    lm = spec.cell(CELL)
    return spec.Cell("trial.small", conf, {**lm.traffic, **SMALL_MIX, **mix}, lm.end_to_end,
                     lm.per_layer)


def test_the_configuration_is_the_ports_phi4_mini():
    from repro_torch.configs import get_config

    conf = spec.config("phi4_mini_bf16")
    ref = lm_decode.load_reference(conf)
    cfg = get_config(conf["arch"])
    assert cfg.replace(**ref.port_fields(conf)) == cfg  # every width as the port states it
    with pytest.raises(ValueError, match="partial_rotary_factor"):
        ref.port_fields(dict(conf, partial_rotary_factor=0.75))


def test_the_reference_agrees_with_the_port_through_prefill_and_decode():
    """The port's prefill and 8 decode steps through its cache against one
    full causal forward of the reference, at phi4_mini's smoke widths in
    float32 on both sides: the sums run in other orders (einsum against
    matmul, the decode's cache), which moves float32 logits by about 1.4e-6 of
    their spread over two layers; 1e-4 of the row's standard deviation
    leaves a hundredfold room, and the bf16 program reads 3e-2 here."""
    conf = _conf(**SMOKE, torch_dtype="float32")
    ref = lm_decode.load_reference(conf)
    mix = {**spec.traffic("decode_ctx3k"), **SMALL_MIX}
    seeds = lm_traffic.seeds(SEED)
    rows = lm_traffic.prompts(mix, conf["vocab_size"], seeds.prompts)
    weights = lm_weights.draw(ref, conf, seeds.weights, "cpu")
    decoder = lm_decode.Decoder(conf, ref, weights, mix, "cpu", "program")
    got, fed = [], []
    with torch.inference_mode():
        logits, caches = decoder.prefill(torch.from_numpy(rows))
        for k in range(9):
            got.append(logits[:, 0].clone())
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            fed.append(cur[:, 0].clone())
            if k < 8:
                logits, caches = decoder.decode(cur, caches, mix["prompt_len"] + k)
    seq = torch.cat([torch.from_numpy(rows), torch.stack(fed[:8], 1).long()], dim=1)
    want = ref.unembed(weights, conf)(ref.hidden(weights, conf, seq, mix["prompt_len"] - 1))
    got = torch.stack(got, 1)
    gap = (got - want).abs().amax(-1) / want.std(-1, unbiased=False)
    assert got.shape == want.shape == (4, 9, conf["vocab_size"])
    assert float(gap.max()) < 1e-4


#: a test size whose depth and initial gain stand in for the cell's: eight
#: layers, and weights of the std that gives each product of width 64 the
#: gain 0.02 gives one of width 3,072, so that rounding grows through the
#: depth as it does at full size
TEST_SIZE = dict(SMOKE, num_hidden_layers=8, initializer_range=0.02 * (3072 / 64) ** 0.5)
#: the limits at the test size, set as the cell's were (PERF.md section 2):
#: over three seeds the program reads up to 0.14 and 0.06 here, the float8
#: control 1.19 and more on ``logit_gap``, each fault 2.2 and more on one
#: of the two numbers
TEST_LIMITS = {"logit_gap": 0.3, "served_token_gap": 0.45}


@pytest.mark.parametrize("mode,correct", [
    ("program", True), ("control", False), ("pos_shift", False), ("token_altered", False),
    ("state_unchanged", False), ("half_batch", False)])
def test_a_run_is_correct_only_with_the_program(mode, correct):
    cell = _cell(_conf(**TEST_SIZE, limits=TEST_LIMITS))
    result = lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu", mode=mode)
    assert result["correct"] is correct, result["checks"]
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(TEST_LIMITS)
    assert result["attempted"] > 0 and (result["failed"] == 0) is correct
    assert set(result["metrics"]) == {"tokens_per_s", "decode_step_p95_ms", "setup_s"}


def test_sessions_that_reach_their_budget_start_again_and_are_judged():
    """A program fast enough to run past a session's decode budget inside
    the window starts its sessions again from the prefill; every session
    decodes the same positions, and the judged rows of any of them pass
    with the program and fail with a fault."""
    cell = _cell(_conf(**TEST_SIZE, limits=TEST_LIMITS), decode_budget=5)
    plain = lm_decode.Loop.run
    windows = []

    def keep(self, **kw):
        windows.append(plain(self, **kw))
        return windows[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm_decode.Loop, "run", keep)
        result = lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu")
        bad = lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu", mode="pos_shift")
    window = windows[1]  # the warm-up's, then the window's
    assert window.steps == WINDOW_STEPS
    assert window.sessions == [1] * 5 + [2] * 5 + [3] * 2  # the warm-up ran session 0
    assert window.positions == [12 + k % 5 for k in range(WINDOW_STEPS)]
    assert np.array_equal(window.tokens[:5], window.tokens[5:10])
    assert result["correct"], result["checks"]
    assert not bad["correct"], bad["checks"]


def test_the_ports_int8_weights_read_between_the_program_and_the_control():
    cell = _cell(_conf(**TEST_SIZE, limits={}))
    reads = {mode: lm_decode.run_cell(cell, SEED, 0.4, False, device="cpu", mode=mode)["checks"]
             for mode in ("program", "int8_weights", "control")}
    gap = {mode: c["logit_gap"]["value"] for mode, c in reads.items()}
    assert gap["program"] < gap["int8_weights"] < gap["control"]


def test_logits_that_are_not_finite_fail_the_run(monkeypatch):
    cell = _cell(_conf(**SMOKE, limits=TEST_LIMITS))
    plain = lm_decode.Decoder.decode

    def nan_first_slot(self, tok, caches, pos):
        logits, new = plain(self, tok, caches, pos)
        return torch.cat([logits[:1] * float("nan"), logits[1:]]), new

    monkeypatch.setattr(lm_decode.Decoder, "decode", nan_first_slot)
    result = lm_decode.run_cell(cell, SEED, 0.3, False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] == lm_decode.NOT_FINITE_GAP


def test_same_seed_same_prompts_and_weights_another_seed_the_same_sizes():
    mix = {**spec.traffic("decode_ctx3k"), **SMALL_MIX}
    a, b, c = lm_traffic.seeds(SEED), lm_traffic.seeds(SEED), lm_traffic.seeds(SEED + 1)
    rows_a, rows_b, rows_c = (lm_traffic.prompts(mix, 256, s.prompts) for s in (a, b, c))
    assert np.array_equal(rows_a, rows_b)
    assert rows_a.shape == rows_c.shape == (4, 12) and not np.array_equal(rows_a, rows_c)
    assert rows_a.dtype == np.int64 and 0 <= rows_a.min() and rows_a.max() < 256
    conf = _conf(**SMOKE)
    ref = lm_decode.load_reference(conf)
    wa, wb = (lm_weights.draw(ref, conf, s.weights, "cpu") for s in (a, b))
    assert wa.keys() == wb.keys() and all(torch.equal(wa[k], wb[k]) for k in wa)
    assert wa["embed/tok"].dtype == torch.bfloat16
    assert float(wa["groups/pos0/mlp/wi_up"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(wa["groups/pos0/attn/norm/scale"], torch.ones(2, 64, dtype=torch.bfloat16))
    assert lm_traffic.max_seq(spec.traffic("decode_ctx3k")) == 4096


def test_the_weights_take_the_ports_layout():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    conf = spec.config("phi4_mini_bf16")
    ref = lm_decode.load_reference(conf)
    like = transformer.abstract_params(get_config("phi4_mini"))
    shapes = {k: torch.empty(shape, device="meta") for k, (shape, _) in
              lm_weights.table(ref, conf).items()}
    tree = lm_weights.nest(shapes, like)
    assert tree["groups"]["pos0"]["attn"]["wq"].shape == (32, 3072, 24, 128)
    assert tree["final_norm"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="leaves differ"):
        lm_weights.nest({k: v for k, v in shapes.items() if k != "embed/tok"}, like)


def test_the_decode_cost_of_phi4_mini():
    conf = spec.config("phi4_mini_bf16")
    ref = lm_decode.load_reference(conf)
    leaves = {k: torch.empty(shape, dtype=torch.bfloat16, device="meta")
              for k, (shape, _) in lm_weights.table(ref, conf).items()}
    cost = yardstick.decode_cost(leaves, ref.cost_terms(conf), 16, conf["vocab_size"])
    assert cost.params == 3_836_021_760 and cost.weight_bytes == 2 * cost.params
    assert cost.kv_bytes_per_position == 32 * 2 * 8 * 128 * 2
    pos = 3072 + 100
    assert cost.step_bytes(pos) == (2 * cost.params + 16 * (131_072 * (pos + 1))
                                    + 16 * 4 * 200_064)
    assert cost.token_flops(pos) == 2 * cost.params + 32 * 4 * 24 * 128 * (pos + 1)
    assert cost.step_bound_s(pos) == pytest.approx(cost.step_bytes(pos) / 3.35e12)


def _run(steps=4, slots=16, trace=True):
    conf = spec.config("phi4_mini_bf16")
    ref = lm_decode.load_reference(conf)
    leaves = {k: torch.empty(shape, dtype=torch.bfloat16, device="meta")
              for k, (shape, _) in lm_weights.table(ref, conf).items()}
    cost = yardstick.decode_cost(leaves, ref.cost_terms(conf), slots, conf["vocab_size"])
    window = lm_decode.DecodeWindow(
        steps=steps, slots=slots, seconds=0.5, latencies_s=[0.1, 0.1, 0.1, 0.2][:steps],
        issue_s=[0.05] * steps, positions=[3072 + k for k in range(steps)],
        sessions=[0] * steps, tokens=np.zeros((steps, slots), np.int64), logits={})
    trace_rec = None
    if trace:  # two traced steps: 30 ms of device work, 10 of it the logits' copy home
        ops = [tracing.DeviceOp("gemv", 0, 20_000_000),
               tracing.DeviceOp("Memcpy DtoH (Device -> Pinned)", 20_000_000, 10_000_000),
               tracing.DeviceOp("gemv", 50_000_000, 10_000_000)]
        trace_rec = tracing.Trace(blocks=2, window_s=0.1, device_ops=ops, busy_s=0.04, gaps=[])
    return lm_decode.Run(spec.cell(CELL), 12.5, window, cost, trace_rec, [3072, 3073])


def test_the_readers_on_a_synthetic_run():
    run = _run()
    got = harness.read_metrics(run, spec.cell(CELL).end_to_end + spec.cell(CELL).per_layer)
    value = {k: v["value"] for k, v in got.items()}
    assert value["tokens_per_s"] == pytest.approx(4 * 16 / 0.5)
    assert value["decode_step_p95_ms"] == pytest.approx(np.percentile([100, 100, 100, 200], 95))
    assert value["setup_s"] == 12.5
    assert value["decode_issue_ms_per_step"] == pytest.approx(50.0)
    assert value["decode_device_ms_per_step"] == pytest.approx(15.0)  # 30 ms over 2 steps
    assert value["decode_idle_share"] == pytest.approx(60.0)
    bound = run.cost.step_bound_s(3072) + run.cost.step_bound_s(3073)
    assert value["decode_hbm_roofline"] == pytest.approx(100 * bound / 0.03)
    flops = sum(run.cost.token_flops(p) for p in run.window.positions) / 4
    assert value["decode_mfu"] == pytest.approx(100 * 128 * flops / yardstick.BF16_FLOPS_PER_S)
    assert got["decode_hbm_roofline"]["unit"] == "%"
    untraced = harness.read_metrics(_run(trace=False), spec.cell(CELL).per_layer)
    assert set(untraced) == {"decode_issue_ms_per_step", "decode_mfu"}


def test_a_trial_cell_of_files_of_its_own_runs_end_to_end(tmp_path, monkeypatch):
    """A new architecture's cell needs new files only: a configuration, a
    traffic mix (and, beside them, a reference and readers)."""
    for sub in ("configs", "traffic"):
        (tmp_path / sub).mkdir()
    conf = _conf(**SMOKE, name="tiny_lm", limits=TEST_LIMITS)
    (tmp_path / "configs" / "tiny_lm.json").write_text(json.dumps(conf))
    mix = {**spec.traffic("decode_ctx3k"), **SMALL_MIX, "why": "a trial mix"}
    (tmp_path / "traffic" / "tiny_decode.json").write_text(json.dumps(mix))
    monkeypatch.setattr(spec, "CONFIGS", tmp_path / "configs")
    monkeypatch.setattr(spec, "TRAFFIC", tmp_path / "traffic")
    cell = spec.cell("tiny_lm.tiny_decode")
    program = harness.load_program(cell.config)
    assert {m["name"] for m in cell.end_to_end} == {"tokens_per_s", "decode_step_p95_ms",
                                                    "setup_s"}
    result = program.run_cell(cell, SEED, 0.3, False, device="cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"tokens_per_s", "decode_step_p95_ms", "setup_s"}
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}
    traced = program.run_cell(cell, SEED + 1, 0.3, True, device="cpu")
    assert traced["correct"] and "breakdown" in traced and traced["device"]["window_s"] > 0
    assert {"decode_issue_ms_per_step", "decode_mfu"} <= set(traced["metrics"])
    assert "decode_hbm_roofline" not in traced["metrics"]  # no device ops on the CPU


def test_the_lm_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json; sys.path[0:0] = ['.', 'src']\n"
        "from perfbench import spec\n"
        "from perfbench.programs import lm_decode\n"
        f"conf = dict(spec.config('phi4_mini_bf16'), **{SMOKE!r})\n"
        f"mix = dict(spec.traffic('decode_ctx3k'), **{SMALL_MIX!r})\n"
        "cell = spec.Cell('t.t', conf, mix, (), ())\n"
        "lm_decode.run_cell(cell, 3, 0.1, False, device='cpu')\n"
        "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))\n"
    )
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=spec.ROOT, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_the_lm_yardstick_imports_nothing_of_the_program_or_of_jax():
    import ast

    files = [spec.HERE / "lm_traffic.py", spec.HERE / "lm_weights.py"]
    files += sorted(spec.REFERENCES.glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.partition(".")[0]
                assert top not in harness.FORBIDDEN_MODULES + ("repro_torch",), (path.name, name)
