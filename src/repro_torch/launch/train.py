"""End-to-end LM training driver: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``: mesh + logical rules, the
grad-accumulation train step, the async prefetching loader,
checkpoint/restart, the SIGTERM preemption hook, straggler mitigation and
optional int8 gradient compression, with the reference's flags plus
``--device`` (``cuda`` by default; without a GPU that raises unless
``--device cpu``).

Data and tensor parallel: with ``torch.distributed`` initialised by the
caller (one rank a device), each rank takes its rows of the global batch
and the step all-reduces the gradients and the loss over the batch axes
to the global mean (``training/lm.py``).  Parameters and their Adam
moments are placed as the reference places them, by
``tree_shardings(rules, abstract_params, logical_axes)``: each rank holds
its part of every leaf the mesh's ``"model"`` axis cuts
(``distributed/sharding.shard_tree``), and the blocks run the collectives
that make the result the whole model's.  Checkpoints gather whole leaves
(every rank saves, rank 0 writes) and restore onto the current mesh,
whatever mesh wrote them.  Rank 0 prints.  The SIGTERM hook sets a flag
that the loop reads after each step; the ranks agree on it and then save
together and exit 143.

One difference from the reference, on resume: the loader starts at the
restored step's batch (the reference's restarts from batch 0, so a resumed
run would see other data than an uninterrupted one).

Straggler policy: the loop tracks a step-time EMA; steps slower than
``straggler_factor`` x EMA are logged and counted, and after
``max_straggler_steps`` consecutive hits the driver checkpoints and exits
with code 75 (EX_TEMPFAIL) so the scheduler can reschedule the job.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import PrefetchingLoader, synthetic_lm_batches
from repro_torch.distributed.sharding import (
    ShardingRules,
    mesh_shape,
    shard_tree,
    tree_shardings,
    use_rules,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.training.checkpoint import CheckpointManager, any_rank
from repro_torch.training.lm import TrainSettings, make_train_step, shard_rows
from repro_torch.training.optimizer import Adam, AdamState, cosine_warmup_schedule


def _rows(make, rules: ShardingRules, start: int, n_micro: int):
    """The loader's batch function: global batch ``start + step``, this
    rank's rows of it."""
    axes = rules.mesh_axes_for("batch")
    n, idx = rules.size(axes), rules.axis_index(axes)

    def rows(step: int):
        batch = make(start + step)
        if batch is None or n == 1:
            return batch
        return {k: shard_rows(v, n_micro, n, idx) for k, v in batch.items()}

    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--scale", type=float, default=1.0, help="width multiplier on the smoke config")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--max-straggler-steps", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        if args.scale != 1.0:
            s = args.scale
            cfg = cfg.replace(
                d_model=int(cfg.d_model * s),
                d_ff=int(cfg.d_ff * s),
                head_dim=int(cfg.head_dim * s),
                vocab=max(cfg.vocab, 1024),
            )
    mesh = (
        make_production_mesh(multi_pod=args.multi_pod, device=dev)
        if args.production_mesh
        else make_host_mesh(device=dev)
    )
    rules = ShardingRules(mesh)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    log(f"arch={cfg.name} params~{T.param_count(cfg)/1e6:.1f}M mesh={mesh_shape(mesh)}")

    opt = Adam(lr=cosine_warmup_schedule(args.lr, warmup=args.warmup, total=args.steps))
    step_fn = make_train_step(
        cfg, opt, TrainSettings(n_micro=args.n_micro, compress_pod_grads=args.compress_pod_grads)
    )

    with use_rules(rules):
        pspecs = tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
        params = shard_tree(T.init_params(0, cfg, device=dev), pspecs, rules, device=dev)
        opt_state = opt.init(params)

        ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name.replace("/", "_"),
                                 save_every=args.ckpt_every,
                                 shardings=(pspecs, AdamState(None, pspecs, pspecs)))
        start_step, (params, opt_state) = ckpt.maybe_restore((params, opt_state), device=dev)
        ckpt.install_preemption_hook()

        loader = PrefetchingLoader(
            _rows(synthetic_lm_batches(cfg.vocab, args.batch, args.seq, n_steps=args.steps),
                  rules, start_step, args.n_micro),
            device=dev,
        )

        ema = None
        stragglers = 0
        losses = []
        t_start = time.time()
        for i, batch in enumerate(loader):
            step = start_step + i
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            ema = dt if ema is None else (0.9 * ema + 0.1 * dt) if i > 2 else dt
            if i > 5 and dt > args.straggler_factor * ema:
                stragglers += 1
                log(f"[straggler] step {step}: {dt:.2f}s vs ema {ema:.2f}s ({stragglers})")
            else:
                stragglers = 0
            # every rank stops at the same boundary (the saves are collective)
            preempted, give_up = any_rank((ckpt.preempt_requested,
                                           stragglers >= args.max_straggler_steps), dev)
            if preempted:
                ckpt.save_emergency(step + 1, (params, opt_state))
                log(f"[preempted] SIGTERM: checkpointed step {step + 1}")
                loader.close()
                raise SystemExit(143)
            if give_up:
                ckpt.save(step + 1, (params, opt_state), extra={"straggler_exit": True})
                log("[straggler] persistent skew -> checkpoint + EX_TEMPFAIL")
                loader.close()
                raise SystemExit(75)
            if ckpt.should_save(step + 1):
                ckpt.save(step + 1, (params, opt_state))
            if step % args.log_every == 0:
                log(f"step {step}: loss={loss:.4f} ({dt:.2f}s/step)")
        n = len(losses)
        if n:
            log(
                f"done: {n} steps in {time.time()-t_start:.1f}s; "
                f"loss {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}"
            )
        ckpt.save(start_step + n, (params, opt_state))
        loader.close()
    return losses


if __name__ == "__main__":
    main()
