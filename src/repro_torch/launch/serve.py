"""Batched greedy serving (the port of :mod:`repro.launch.serve`):
token-by-token prefill through the decode step, then a greedy decode
loop over the KV/SSM cache.

    python -m repro_torch.launch.serve --arch zamba2-7b --device cpu
    python -m repro_torch.launch.serve --arch zamba2-7b --full   # on a card

``--smoke`` (the default, as the reference hard-codes) serves the
reduced config; ``--full`` the registry's full config, which needs the
card (zamba2-7b: 6.75 B parameters, 27 GB in float32). Parameters are
drawn on the device from ``--seed``.

``--checkpoint PATH`` snapshots the parameters (atomically: the write
goes to a temp file and lands by rename, so an interrupt never corrupts
the previous snapshot) before generation and on interrupt; ``--resume
CKPT`` restores them from such a snapshot, saved for the same
``--arch``, instead of the seeded draw. A first SIGINT exits cleanly:
the decode loop stops at the next token boundary, the snapshot is
flushed with ``interrupted: true`` and the partial generation is
reported; a second SIGINT aborts.
"""
from __future__ import annotations

import argparse
import json
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import frontend_inputs, make_decode_step
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params


@torch.no_grad()
def greedy_generate(cfg, params, prompts: np.ndarray, gen: int,
                    cache_len: int | None = None, should_stop=None):
    """prompts (B, P) int32; returns (tokens (B, P+gen') numpy int32,
    decode tokens/s). Runs on the device of ``params``. An enc-dec arch
    first encodes zero frames into the cache's cross K/V.

    ``should_stop`` — optional zero-argument callable polled before
    every decode step; True ends generation at that token boundary,
    possibly with fewer than ``gen`` generated tokens."""
    device = params["embed"]["tok"].device
    B, P = prompts.shape
    cache = init_params(T.init_cache_specs(cfg, B, cache_len or (P + gen)),
                        device=device)
    if cfg.family == "encdec":
        frames = frontend_inputs(cfg, B, device)["frames"]
        _, cache["cross_k"], cache["cross_v"] = T.encode(params, frames, cfg)
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
        if should_stop is not None and should_stop():
            break
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
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="atomically snapshot the parameters here (and "
                         "flush on SIGINT)")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="restore the parameters from a --checkpoint "
                         "snapshot instead of the seeded draw")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    params = init_params(T.specs(cfg), seed=args.seed, device=device)
    resumed = False
    if args.resume is not None:
        params, meta = ckpt.restore(args.resume, params)
        if meta.get("arch") not in (None, args.arch):
            raise SystemExit(
                f"--resume snapshot was saved for arch "
                f"{meta.get('arch')!r}, not {args.arch!r}")
        resumed = True
    meta = {"arch": args.arch, "seed": args.seed,
            "config": "full" if args.full else "smoke"}
    if args.checkpoint is not None:
        ckpt.save(args.checkpoint, params, meta)

    # first SIGINT: finish the token in flight, flush the checkpoint and
    # exit cleanly with the partial generation; second SIGINT: abort
    interrupted = False
    prev_handler = signal.getsignal(signal.SIGINT)

    def _on_sigint(signum, frame):
        nonlocal interrupted
        if interrupted:
            raise KeyboardInterrupt
        interrupted = True

    signal.signal(signal.SIGINT, _on_sigint)
    try:
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len)).astype(np.int32)
        toks, tps = greedy_generate(cfg, params, prompts, args.gen,
                                    should_stop=lambda: interrupted)
        if interrupted and args.checkpoint is not None:
            ckpt.save(args.checkpoint, params, {**meta, "interrupted": True})
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    out = {"arch": args.arch, "config": "full" if args.full else "smoke",
           "device": str(device), "batch": args.batch,
           "generated_shape": list(toks.shape),
           "decode_tokens_per_s": round(tps, 1),
           "interrupted": interrupted, "resumed": resumed,
           "sample": toks[0, -10:].tolist()}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
