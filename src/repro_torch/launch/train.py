"""End-to-end LM training driver (the reference's
``repro/launch/train.py``).

    python -m repro_torch.launch.train --device cpu --arch qwen2-0.5b \\
        --reduced --steps 50 --seq-len 128 --global-batch 8 \\
        --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train        # qwen2-0.5b on the card

The loop runs every layer of the training substrate: the deterministic
data pipeline (numpy batches, prefetched), the train step (kernels D and
E on the card, flash attention with its recompute backward, optional
remat, chunked cross entropy), AdamW, atomic checkpointing with resume,
and the fault-tolerance controller's hooks.  It returns the reference's
result dict, with each step's loss under ``losses``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.sweep import resolve_device
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Batch
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FaultToleranceController,
                                                 FTConfig)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced d_model (0 = default)")
    ap.add_argument("--num-layers", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def device_batch(batch: Batch, dev: torch.device) -> Batch:
    """A numpy batch of the pipeline as int64 tensors on ``dev``."""
    return Batch(tokens=torch.as_tensor(batch.tokens, device=dev).long(),
                 labels=torch.as_tensor(batch.labels, device=dev).long())


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.num_layers:
        overrides["num_layers"] = args.num_layers
    cfg = (get_reduced_config(args.arch, **overrides) if args.reduced
           else get_config(args.arch))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps)

    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt_state = adamw.init(opt_cfg, params)
    n_params = T.param_count(params)
    print(f"[train] arch={cfg.name} params={n_params/1e6:.2f}M "
          f"layers={cfg.num_layers} d={cfg.d_model} device={dev}")

    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            # restore gives CPU tensors: move them to the device
            state = ckpt.restore(latest, {"params": params,
                                          "opt": opt_state})
            params = T.to_device(state["params"], dev)
            opt_state = adamw.AdamWState(
                *(T.to_device(x, dev) for x in state["opt"]))
            start_step = latest
            print(f"[train] resumed from step {latest}")
    params = steps_mod.trainable(params)

    dc = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                    seed=args.seed)
    pipeline = make_pipeline(cfg, dc, start_step=start_step)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, remat=args.remat)

    ft = FaultToleranceController(num_workers=1, cfg=FTConfig())
    losses, times = [], []
    t_wall = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = device_batch(next(pipeline), dev)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            ft.heartbeat(0, now=time.time())
            ft.report_step(0, step, dt)
            losses.append(loss)
            times.append(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step={step:5d} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={dt*1e3:.0f}ms")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          metadata={"loss": loss})
    finally:
        pipeline.close()
    result = {
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_decreased": losses[-1] < losses[0],
        "steps": len(losses),
        "mean_step_s": float(np.mean(times[1:])) if len(times) > 1 else 0,
        "wall_s": time.time() - t_wall,
        "losses": losses,
    }
    print(f"[train] done: loss {result['first_loss']:.4f} -> "
          f"{result['last_loss']:.4f} in {result['wall_s']:.1f}s")
    return result


if __name__ == "__main__":
    main()
