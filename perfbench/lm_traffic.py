"""The one generator of LM decode traffic: every mix is a file of parameters
it reads.

A mix (``perfbench/traffic/<mix>.json`` with ``"kind": "lm_decode"``) gives:

* ``slots``: sessions decoded together, one a batch row;
* ``prompt_len``: each session's prompt, in tokens (every slot's alike, so
  the port's server pads none);
* ``decode_budget``: decode steps a session runs before it starts again
  from its prompt, so the caches hold ``prompt_len + decode_budget``
  positions (a program fast enough to reach the budget inside a window
  restarts its sessions there, instead of running past its caches);
* ``inflight``: decode steps issued before the host reads one's tokens (1:
  the server reads every step's tokens before it issues the next);
* ``logits_every``: every this many steps a step's logits go home for the
  comparison, from an offset drawn from the seed, into a ring of
  ``logits_kept`` pinned buffers (the last ``logits_kept`` sent are judged);
* ``warmup_steps``: decode steps run before the window; ``trace_steps``:
  steps profiled after it in a ``--trace 1`` run.

Token ids are uniform over the configuration's vocabulary.  Everything is
drawn from the run's seed (:func:`seeds`): the same seed gives the same
prompts, the same sampled steps and the same weights; another seed gives
other values at the same sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: the traffic kind this generator reads
KIND = "lm_decode"
KEYS = ("slots", "prompt_len", "decode_budget", "inflight", "logits_every", "logits_kept",
        "warmup_steps", "trace_steps")


def validate(mix: dict, name: str = "") -> dict:
    """``mix`` itself, or a ``ValueError`` naming what this generator cannot run."""
    if mix.get("kind") != KIND:
        raise ValueError(f"traffic {name!r}: kind must be {KIND!r}, got {mix.get('kind')!r}")
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name!r}: missing {', '.join(missing)}")
    if mix["inflight"] != 1:
        raise ValueError(f"traffic {name!r}: the server reads every step's tokens before "
                         f"the next step; inflight must be 1")
    if min(mix["slots"], mix["prompt_len"], mix["decode_budget"], mix["logits_every"]) < 1:
        raise ValueError(f"traffic {name!r}: slots, prompt_len, decode_budget and logits_every "
                         f"must be >= 1")
    return mix


def max_seq(mix: dict) -> int:
    """Positions a session's caches hold: its prompt and its budget."""
    return int(mix["prompt_len"]) + int(mix["decode_budget"])


@dataclasses.dataclass(frozen=True)
class Seeds:
    """Independent streams of one run's seed: the weights' generator seed,
    the prompts' and the sample's numpy seeds."""

    weights: int
    prompts: np.random.SeedSequence
    sample: np.random.SeedSequence


def seeds(seed: int) -> Seeds:
    """Split a run's seed (any non-negative whole number) into its streams."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    weights, prompts, sample = np.random.SeedSequence(seed).spawn(3)
    return Seeds(int(weights.generate_state(1, np.uint64)[0] >> np.uint64(1)), prompts, sample)


def prompts(mix: dict, vocab: int, seq: np.random.SeedSequence) -> np.ndarray:
    """(slots, prompt_len) int64 token rows, uniform over the vocabulary."""
    rng = np.random.default_rng(seq)
    return rng.integers(0, vocab, (int(mix["slots"]), int(mix["prompt_len"])), dtype=np.int64)


def logits_offset(mix: dict, rng: np.random.Generator) -> int:
    """The first window step whose logits go home, drawn from the sample's
    stream (``np.random.default_rng(seeds(...).sample)``, which then draws
    the sessions judged); every ``logits_every``-th step after it goes home
    too."""
    return int(rng.integers(0, mix["logits_every"]))
