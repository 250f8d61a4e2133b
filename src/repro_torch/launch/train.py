"""Training launcher on one card (the port of ``repro.launch.train``), with
checkpoint/restart and the straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \
        --reduced --steps 50 --batch 8 --seq 128 [--ckpt-dir ckpts] [--resume] \
        [--device cpu]

Parameters are ``init_train_state(PRNGKey(0))`` (float32 master weights,
bfloat16 compute) and the data ``SyntheticLM(vocab, seq, batch, seed=17)``:
the reference's bits.  Step times are host clocks around work that ends in
a synchronize.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import rng
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft import StepWatchdog
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, TrainConfig, init_train_state, make_train_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run the CLI; returns what it built and measured (``cfg``, ``model``,
    ``params``, ``opt``, ``start``, per step run ``losses``,
    ``grad_norms`` and ``step_s``, and ``init_s``) for callers that go on
    with the same model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=5, decay_steps=max(args.steps, 10)),
        microbatches=args.microbatches,
    )
    step_fn = make_train_step(model, tcfg)
    _sync(dev)
    t0 = time.time()
    params, opt = init_train_state(model, rng.PRNGKey(0, device=dev))
    _sync(dev)
    init_s = time.time() - t0
    start = 0
    if args.resume and args.ckpt_dir:
        path = ckpt.latest(args.ckpt_dir)
        if path:
            restored, start = ckpt.restore(path, {"params": params, "opt": opt}, device=dev)
            params, opt = restored["params"], restored["opt"]
            print(f"resumed from {path} at step {start}")

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=17)
    watchdog = StepWatchdog()
    pending = None
    losses, grad_norms, step_s = [], [], []
    for i in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.shard_batch(i).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        _sync(dev)
        dt = time.time() - t0
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(dt)
        if watchdog.observe(dt):
            print(f"step {i}: WATCHDOG straggling steps detected")
        if i % 5 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d} loss={losses[-1]:.4f} "
                f"gnorm={grad_norms[-1]:.3f} "
                f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
            )
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if pending:
                pending.join()
            pending = ckpt.save_async(
                f"{args.ckpt_dir}/step_{i+1}", i + 1,
                {"params": params, "opt": opt},
            )
    if pending:
        pending.join()
    print(f"done; loss floor (markov entropy) = {data.entropy_floor():.3f}")
    return {"cfg": cfg, "model": model, "params": params, "opt": opt, "start": start,
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s, "init_s": init_s}


if __name__ == "__main__":
    main()
