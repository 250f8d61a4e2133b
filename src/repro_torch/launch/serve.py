"""Serving launcher: batched prefill + greedy decode on one card (the
port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --reduced \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Parameters are ``init_params(PRNGKey(0))`` in bfloat16 and the prompts
``randint(PRNGKey(1), (batch, prompt_len), 0, vocab)``: the reference's
bits.  Times are host clocks around work that ends in a synchronize.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import rng
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import make_serve_steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, params, prompts, gen: int):
    """Prefill ``prompts (B, P)``, then ``gen - 1`` greedy decode steps
    through ``make_serve_steps``.  Returns ``(tokens (B, gen), prefill
    seconds, decode seconds)``."""
    dev = prompts.device
    prefill_step, decode_step = make_serve_steps(model)
    _sync(dev)
    t0 = time.time()
    logits, cache, cache_len = prefill_step(params, {"tokens": prompts}, prompts.shape[1] + gen)
    _sync(dev)
    t_prefill = time.time() - t0
    toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [toks]
    t0 = time.time()
    for _ in range(gen - 1):
        logits, cache, cache_len = decode_step(params, cache, toks, cache_len)
        toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(toks)
    _sync(dev)
    return torch.cat(out, dim=1), t_prefill, time.time() - t0


def main(argv=None) -> dict:
    """Run the CLI; returns what it built and measured (``cfg``, ``model``,
    ``params``, ``prompts``, ``tokens``, ``init_s``, ``prefill_s``,
    ``decode_s``) for callers that go on with the same model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg)
    _sync(dev)
    t0 = time.time()
    params = model.init_params(rng.PRNGKey(0, device=dev), torch.bfloat16)
    _sync(dev)
    init_s = time.time() - t0
    prompts = rng.randint(rng.PRNGKey(1, device=dev), (args.batch, args.prompt_len), 0,
                          cfg.vocab)
    gen, t_prefill, t_decode = generate(model, params, prompts, args.gen)
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill*1e3:.0f}ms")
    print(
        f"decode {args.gen-1} steps: {t_decode*1e3:.0f}ms "
        f"({(args.gen-1)*args.batch/max(t_decode,1e-9):.1f} tok/s)"
    )
    print("sample:", gen[0][:12].tolist())
    return {"cfg": cfg, "model": model, "params": params, "prompts": prompts, "tokens": gen,
            "init_s": init_s, "prefill_s": t_prefill, "decode_s": t_decode}


if __name__ == "__main__":
    main()
