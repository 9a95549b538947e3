"""Batched greedy serving (the port of :mod:`repro.launch.serve`):
token-by-token prefill through the decode step, then a greedy decode
loop over the KV/SSM cache.

    python -m repro_torch.launch.serve --arch zamba2-7b --device cpu
    python -m repro_torch.launch.serve --arch zamba2-7b --full   # on a card

``--smoke`` (the default, as the reference hard-codes) serves the
reduced config; ``--full`` the registry's full config, which needs the
card (zamba2-7b: 6.75 B parameters, 27 GB in float32). Parameters are
drawn on the device from ``--seed``. ``--checkpoint`` and ``--resume``
are not ported yet (ROADMAP.md, queue 1 item 9).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params


@torch.no_grad()
def greedy_generate(cfg, params, prompts: np.ndarray, gen: int,
                    cache_len: int | None = None):
    """prompts (B, P) int32; returns (tokens (B, P+gen) numpy int32,
    decode tokens/s). Runs on the device of ``params``."""
    device = params["embed"]["tok"].device
    B, P = prompts.shape
    cache = init_params(T.init_cache_specs(cfg, B, cache_len or (P + gen)),
                        device=device)
    step = make_decode_step(cfg)

    def next_token(tok, pos):
        logits, _ = step(params, cache, {"tokens": tok}, pos)
        return logits[:, -1, :cfg.vocab_size].argmax(dim=-1) \
            .to(torch.int32)[:, None]

    toks = torch.from_numpy(np.ascontiguousarray(prompts, np.int32)) \
        .to(device)
    for i in range(P):                 # prefill through the decode path
        nxt = next_token(toks[:, i:i + 1], i)
    out = [nxt]
    synchronize(device)
    t0 = time.perf_counter()
    for g in range(gen - 1):
        out.append(next_token(out[-1], P + g))
    synchronize(device)
    dt = time.perf_counter() - t0
    gen_toks = torch.cat(out, dim=1).cpu().numpy()
    return (np.concatenate([prompts, gen_toks], axis=1),
            (len(out) - 1) / max(dt, 1e-9) * B)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda by default; cpu "
                         "runs the kernels' plain versions)")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", dest="full", action="store_false",
                      help="the reduced config (default)")
    size.add_argument("--full", dest="full", action="store_true",
                      help="the registry's full config")
    ap.set_defaults(full=False)
    ap.add_argument("--checkpoint", default=None, metavar="PATH")
    ap.add_argument("--resume", default=None, metavar="CKPT")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.checkpoint or args.resume:
        raise SystemExit("--checkpoint/--resume is not ported to "
                         "repro_torch yet (ROADMAP.md, queue 1 item 9: "
                         "faults and recovery)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    params = init_params(T.specs(cfg), seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    toks, tps = greedy_generate(cfg, params, prompts, args.gen)
    out = {"arch": args.arch, "config": "full" if args.full else "smoke",
           "device": str(device), "batch": args.batch,
           "generated_shape": list(toks.shape),
           "decode_tokens_per_s": round(tps, 1),
           "sample": toks[0, -10:].tolist()}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
