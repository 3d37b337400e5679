"""The port's LM serving path under decode traffic: sessions prefilled in
set-up, then decoded greedily token by token in a closed loop.

The system under test is the port's server, ``repro_torch.launch.serve.
BatchedServer``: its ``_prefill`` (``transformer.forward_with_cache``) fills
the sessions' caches and its ``_decode`` (``transformer.decode_step``)
decodes them.  Each step does what the server's ``_serve_batch`` does:
greedy argmax of the step's logits, and every slot's token read back to
the host (``int(cur[i, 0])``) before the next step is issued, so the host's
share of a step is the server's.  The configuration names the port's
architecture (``"arch"``) and its reference (``"reference"``,
``perfbench/references/<name>.py``), which states the weights' leaves and
the port's fields; the weights are drawn on the card from the seed
(``lm_weights``) and handed to the port as its params tree
(``lm_weights.nest`` against ``transformer.abstract_params``, the layout
``params_from_numpy`` builds).  The traffic is an ``lm_traffic`` mix.

A run: set-up draws the weights, prefills the slots' prompts (``prefill_s``
on stderr) and runs the warm-up steps; the window decodes for
``--seconds``, a session starting again from the prefill's caches and
first token once it has run its decode budget (``decode_step`` leaves the
caches it is given unchanged, so the prefill's serve every session); every
``logits_every``-th step the step's logits go home by a non-blocking copy
into pinned memory.  ``--trace 1`` profiles ``trace_steps`` more steps.
Then the program's state is freed and the reference judges the window
(:func:`judge`).

``run_cell(..., mode=...)`` puts a control or a planted fault in the
program's place (:data:`MODES`); the benchmark's own runs take
``"program"``.  ``"control"`` is the reference computed one precision
below the configuration's bf16, in float8 e4m3, teacher-forced over the
same prompts and served tokens: its logits are judged in place of the
program's, and the token it puts first at each position in place of the
served one.  ``"int8_weights"`` is the port's own int8 weight-only path
(``quantize_lm_params``); the faults are a decode at ``pos + 1``, one
served token altered where it is produced, a step that returns the caches
it was given, and half the slots decoded with the rest given their mean.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import sys
import time

import numpy as np
import torch

from perfbench import harness, lm_traffic, lm_weights, spec, tracing, yardstick

#: the gap a row reads where the program's logits are not finite
NOT_FINITE_GAP = 1e9
#: the numbers a row can be judged by (:func:`judge`); the configuration's
#: ``limits`` name those compared
NUMBERS = ("logit_gap", "served_token_gap")
#: positions of the reference's logits made at once
UNEMBED_BLOCK = 64
#: the program, the controls, and the faults a decode cell can have
MODES = ("program", "control", "int8_weights", "pos_shift", "token_altered", "state_unchanged",
         "half_batch")
#: the window step, and the slot, whose token ``token_altered`` alters
ALTER_STEP, ALTER_SLOT = 1, 1


def load_reference(conf: dict):
    """The module ``perfbench/references/<reference>.py`` the configuration names."""
    path = spec.REFERENCES / f"{conf['reference']}.py"
    mod_spec = importlib.util.spec_from_file_location("perfbench_reference_" + conf["reference"],
                                                      path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class DecodeWindow:
    """What a run of decode steps recorded on the host clock."""

    steps: int
    slots: int
    seconds: float
    latencies_s: list[float]  # a step's issue to all its tokens on the host
    issue_s: list[float]  # the host's time in the decode call
    positions: list[int]  # each step's position
    sessions: list[int]  # each step's session
    tokens: np.ndarray  # (steps, slots): the token each step served
    logits: dict[int, np.ndarray]  # step -> (slots, vocab) logits kept for the comparison


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window: DecodeWindow
    cost: yardstick.DecodeCost
    trace: tracing.Trace | None
    traced_positions: list[int]


class Decoder:
    """The port's server on the seeded weights, in ``mode``'s version."""

    def __init__(self, conf: dict, ref, weights: dict, mix: dict, device, mode: str):
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import BatchedServer
        from repro_torch.models import transformer

        self.cfg = get_config(conf["arch"]).replace(**ref.port_fields(conf))
        params = lm_weights.nest(weights, transformer.abstract_params(self.cfg))
        if mode == "int8_weights":  # the port's int8 weight-only path
            from repro_torch.models.quantized import quantize_lm_params

            params = quantize_lm_params(params, cfg=self.cfg)
        self.server = BatchedServer(self.cfg, params, batch_slots=int(mix["slots"]),
                                    max_seq=lm_traffic.max_seq(mix), device=device)
        self.mode = mode

    def prefill(self, tokens: torch.Tensor):
        return self.server._prefill(self.server.params, {"tokens": tokens})

    def decode(self, tok: torch.Tensor, caches, pos: int):
        """One step: (logits (slots, 1, vocab), the caches the next step takes)."""
        if self.mode == "pos_shift":
            pos += 1
        if self.mode == "half_batch":  # half the slots decoded, the rest their mean
            half = tok.shape[0] // 2
            part, part_new = self.server._decode(
                self.server.params, tok[:half], _tree_map(lambda c: c.narrow(1, 0, half), caches),
                pos)
            rest = part.mean(dim=0, keepdim=True).expand(tok.shape[0] - half, -1, -1)
            keep = lambda c, n: torch.cat([n, c.narrow(1, half, c.shape[1] - half)], dim=1)
            return torch.cat([part, rest]), _tree_map2(keep, caches, part_new)
        logits, new = self.server._decode(self.server.params, tok, caches, pos)
        return logits, (caches if self.mode == "state_unchanged" else new)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _tree_map2(fn, a, b):
    return ({k: _tree_map2(fn, a[k], b[k]) for k in a} if isinstance(a, dict) else fn(a, b))


class Loop:
    """The closed loop of decode steps (see the module docstring)."""

    def __init__(self, decoder: Decoder, first: torch.Tensor, caches, mix: dict, vocab: int,
                 offset: int, device: torch.device):
        cuda = device.type == "cuda"
        self.decoder, self.first, self.prefilled = decoder, first, caches
        self.slots, self.vocab = first.shape[0], vocab
        self.prompt_len, self.budget = int(mix["prompt_len"]), int(mix["decode_budget"])
        self.every, self.offset = int(mix["logits_every"]), offset
        self.kept = torch.empty((int(mix["logits_kept"]), self.slots, vocab), dtype=torch.float32,
                                pin_memory=cuda)
        self.alter = decoder.mode == "token_altered"
        self.session = -1
        self.restart()

    def restart(self) -> None:
        """A new session from the prefill's caches and first token."""
        self.caches, self.cur, self.k = self.prefilled, self.first, 0
        self.session += 1

    def run(self, *, seconds: float | None = None, steps: int | None = None,
            traced: bool = False, judged: bool = False) -> DecodeWindow:
        span = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
        lat, issue, positions, sessions, tokens, kept = [], [], [], [], [], {}
        n_kept = self.kept.shape[0]
        t0 = last = time.perf_counter()
        j = 0
        while True:
            now = time.perf_counter()
            if seconds is not None and now - t0 >= seconds or steps is not None and j >= steps:
                break
            if self.k == self.budget:
                self.restart()
            pos = self.prompt_len + self.k
            with span("perfbench.decode"):
                logits, self.caches = self.decoder.decode(self.cur, self.caches, pos)
            a = time.perf_counter()
            with span("perfbench.argmax"):
                self.cur = torch.argmax(logits, dim=-1).to(torch.int32)
                if self.alter and judged and j == ALTER_STEP:
                    self.cur[ALTER_SLOT] = (self.cur[ALTER_SLOT] + 1) % self.vocab
            send = j >= self.offset and (j - self.offset) % self.every == 0
            if send:
                with span("perfbench.send_home"):
                    buf = self.kept[len(kept) % n_kept]
                    buf.copy_(logits[:, 0], non_blocking=True)
                    kept[j] = buf
            with span("perfbench.harvest"):  # the server's read-back, slot by slot
                row = [int(self.cur[i, 0]) for i in range(self.slots)]
            last = time.perf_counter()
            lat.append(last - now)
            issue.append(a - now)
            positions.append(pos)
            sessions.append(self.session)
            tokens.append(row)
            self.k += 1
            j += 1
        # a ring: the last ``logits_kept`` sent steps hold their buffers still
        logits = {s: buf.numpy().copy() for s, buf in list(kept.items())[-n_kept:]}
        return DecodeWindow(j, self.slots, last - t0, lat, issue, positions, sessions,
                            np.asarray(tokens, np.int64).reshape(j, self.slots), logits)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, t_start=None,
             device="cuda", mode: str = "program") -> dict:
    """One run: the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    conf, mix = cell.config, lm_traffic.validate(cell.traffic, cell.name)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    unknown = set(conf.get("limits") or {}) - set(NUMBERS)
    if unknown:
        raise ValueError(f"limits on unknown numbers {sorted(unknown)}; known: {NUMBERS}")
    ref = load_reference(conf)
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("card", time.perf_counter()))
    seeds = lm_traffic.seeds(seed)
    vocab = int(conf["vocab_size"])
    rows = lm_traffic.prompts(mix, vocab, seeds.prompts)
    sample = np.random.default_rng(seeds.sample)
    offset = lm_traffic.logits_offset(mix, sample)
    weights = lm_weights.draw(ref, conf, seeds.weights, dev)
    cost = yardstick.decode_cost(weights, ref.cost_terms(conf), int(mix["slots"]), vocab)
    decoder = Decoder(conf, ref, weights, mix, dev, mode)
    del weights
    marks.append(("weights", time.perf_counter()))
    with torch.inference_mode():
        logits, caches = decoder.prefill(torch.from_numpy(rows).to(dev))
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        del logits
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append(("prefill", time.perf_counter()))
        loop = Loop(decoder, first, caches, mix, vocab, offset, dev)
        del caches
        loop.run(steps=int(mix["warmup_steps"]))
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        loop.restart()
        window = loop.run(seconds=seconds, judged=True)
        trace_rec, traced_positions = None, []
        if trace:
            traced, trace_rec = _traced_segment(loop, int(mix["trace_steps"]), cuda)
            traced_positions = traced.positions
    steps = [(name, t - (marks[i - 1][1] if i else t_start)) for i, (name, t) in enumerate(marks)]
    print("setup: " + ", ".join(f"{name} {secs:.3f} s" for name, secs in steps), file=sys.stderr)
    print(f"prefill_s: {dict(steps)['prefill']:.4f}", file=sys.stderr)
    if window.steps:
        q = np.percentile(window.latencies_s, [5, 50, 95, 100]) * 1e3
        print(f"window: {window.steps} steps, step ms p5 {q[0]:.2f} p50 {q[1]:.2f} p95 {q[2]:.2f} "
              f"max {q[3]:.2f}, issue ms p50 {np.median(window.issue_s) * 1e3:.2f}",
              file=sys.stderr)
    card = harness.card_line() if cuda else "cpu"
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    first = first.cpu().numpy()[:, 0]
    del loop, decoder
    gc.collect()  # the server's dispatch core holds it in a cycle, and with it the weights
    if cuda:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    gaps = judge(ref, conf, seeds.weights, rows, first, window, sample, dev,
                 control=mode == "control")
    print(f"reference_s: {time.perf_counter() - t_judge:.4f} ({window.steps} steps x "
          f"{window.slots} slots judged)", file=sys.stderr)
    limits = {k: v for k, v in (conf.get("limits") or {}).items() if v is not None}
    over = np.zeros(gaps["served_token_gap"].shape, bool)
    for name, limit in limits.items():
        over |= np.nan_to_num(gaps[name], nan=-np.inf) > limit
    sampled = ~np.isnan(gaps["logit_gap"])
    failed = int(over.sum()) if limits else int(over.size)
    correct = failed == 0 and over.size > 0 and bool(sampled.any())

    run = Run(cell, setup_s, window, cost, trace_rec, traced_positions)
    metrics = harness.read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    result = {
        "correct": bool(correct),
        "attempted": int(over.size),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace_rec is not None:
        result["device"]["busy_s"] = trace_rec.busy_s
        result["device"]["window_s"] = trace_rec.window_s
        result["breakdown"] = trace_rec.breakdown()
    result["card"] = card
    result["checks"] = {
        name: {"value": _widest(gaps[name]), "limit": limits.get(name)}
        for name in NUMBERS if name in limits or not limits}
    return result


def _widest(values: np.ndarray) -> float:
    """The widest of the gaps that were read; :data:`NOT_FINITE_GAP` where none was."""
    read = values[~np.isnan(values)]
    return float(read.max()) if read.size else NOT_FINITE_GAP


def _traced_segment(loop: Loop, steps: int, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(tracing.TRACED):
            window = loop.run(steps=steps, traced=True)
            if cuda:
                torch.cuda.synchronize()
    return window, tracing.reduce(prof.profiler.kineto_results.events(), steps)


def judge(ref, conf: dict, weights_seed: int, rows: np.ndarray, first: np.ndarray,
          window: DecodeWindow, rng: np.random.Generator, device, *,
          control: bool = False) -> dict[str, np.ndarray]:
    """Each of :data:`NUMBERS` for the window's judged rows, a row being one
    slot at one step of one session, each slot's session drawn from ``rng``
    among those whose logits came home (the window's first session while
    no session ends inside it):

    * ``served_token_gap``: by how much the reference's logit of the token
      the program served lies below the reference's best;
    * ``logit_gap``, for the rows whose logits came home (NaN for the
      others): the widest gap between the program's logits and the
      reference's;

    each over the standard deviation of the reference's row, and
    :data:`NOT_FINITE_GAP` where the program's logits are not finite.  The
    reference is teacher-forced: it runs once over each slot's prompt, the
    prefill's first token and the tokens the program served.
    With ``control``, the reference in float8 (``fp8=True``) over the same
    tokens stands in the program's place: its logits, and at each position
    the token it puts first."""
    weights = lm_weights.draw(ref, conf, weights_seed, device)
    unembed = ref.unembed(weights, conf)
    unembed_low = ref.unembed(weights, conf, fp8=True) if control else None
    prompt_len = rows.shape[1]
    sessions = np.asarray(window.sessions)
    pool = sorted({window.sessions[j] for j in window.logits}) or sorted(set(window.sessions))
    chosen = rng.choice(pool, size=window.slots) if pool else np.zeros(0, np.int64)
    out = {name: [] for name in NUMBERS}
    for s in np.unique(chosen):
        slots = np.nonzero(chosen == s)[0]
        steps = np.nonzero(sessions == s)[0]  # session steps 0, 1, ... in order
        fed = np.concatenate([first[slots, None], window.tokens[steps[:-1]][:, slots].T], axis=1)
        seq = torch.from_numpy(np.concatenate([rows[slots], fed], axis=1)).to(device)
        h = ref.hidden(weights, conf, seq, prompt_len)  # (slots, steps, d)
        h_low = ref.hidden(weights, conf, seq, prompt_len, fp8=True) if control else None
        for lo in range(0, len(steps), UNEMBED_BLOCK):
            want = unembed(h[:, lo:lo + UNEMBED_BLOCK])  # (slots, block, vocab)
            std = want.std(dim=-1, unbiased=False)
            best = want.max(dim=-1).values
            if control:
                low = unembed_low(h_low[:, lo:lo + UNEMBED_BLOCK])
                got_tok = low.argmax(dim=-1)
            else:
                got_tok = torch.from_numpy(
                    window.tokens[steps[lo:lo + UNEMBED_BLOCK]][:, slots].T).to(device)
            picked = want.gather(-1, got_tok[..., None])[..., 0]
            out["served_token_gap"].append(((best - picked) / std).T.cpu().numpy())
            widest = np.full((len(steps[lo:lo + UNEMBED_BLOCK]), len(slots)), np.nan)
            for b, j in enumerate(steps[lo:lo + UNEMBED_BLOCK]):
                if j in window.logits:
                    got = (low[:, b] if control else
                           torch.from_numpy(window.logits[j][slots]).to(device))
                    gap = (got - want[:, b]).abs().max(dim=-1).values / std[:, b]
                    finite = torch.isfinite(got).all(dim=-1).cpu().numpy()
                    widest[b] = np.where(finite, gap.cpu().numpy(), NOT_FINITE_GAP)
            out["logit_gap"].append(widest)
    return {name: np.concatenate([a.reshape(-1) for a in arrays]) if arrays else np.zeros(0)
            for name, arrays in out.items()}
