"""Digests of one-device greedy decoding: its tokens and every step's
logits, bit for bit, so that two trees' plain decode paths can be held
to each other on one card.

For every smoke config, and for minitron-4b, mixtral-8x7b, whisper-
large-v3 (two decoder and two encoder layers) and zamba2-7b (one hybrid
group) at full width, it decodes a seeded batch of 2 prompts of 16
tokens through ``decode_step`` (the prompt through the decode path, as
``serve.greedy_generate`` does) and 8 generated tokens, on plain
tensors, and hashes the tokens and the bytes of every step's logits
(sha256). Prints one JSON line: {"device", "torch", "digests": {name:
{"tokens", "logits"}}}.

Usage:
  python scripts/serve_digest.py [--device cpu] [--smoke-only]
  # two trees on one card, in turns:
  PYTHONPATH=OTHER/src python scripts/serve_digest.py > a.json
"""
from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch

from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch.steps import frontend_inputs, make_decode_step
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params

B, P, GEN = 2, 16, 8
FULL = {"minitron-4b": {"num_layers": 2},
        "mixtral-8x7b": {"num_layers": 2},
        "whisper-large-v3": {"num_layers": 2, "encoder_layers": 2},
        "zamba2-7b": {"num_layers": 6, "attn_every": 6}}


def digest(cfg, device) -> dict:
    params = init_params(T.specs(cfg), seed=0, device=device)
    cache = init_params(T.init_cache_specs(cfg, B, P + GEN), device=device)
    if cfg.family == "encdec":
        frames = frontend_inputs(cfg, B, device)["frames"]
        _, cache["cross_k"], cache["cross_v"] = T.encode(params, frames, cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32)).to(device)
    step = make_decode_step(cfg)
    logits, out = hashlib.sha256(), []
    nxt = toks[:, :1]
    with torch.no_grad():
        for i in range(P + GEN - 1):
            lg, cache = step(params, cache, {"tokens": toks[:, i:i + 1]
                                             if i < P else nxt}, i)
            logits.update(lg.float().cpu().numpy().tobytes())
            nxt = lg[:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            if i >= P - 1:
                out.append(nxt)
    return {"tokens": hashlib.sha256(torch.cat(out, 1).cpu().numpy()
                                     .tobytes()).hexdigest(),
            "logits": logits.hexdigest()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke-only", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")
    runs = [(f"{a}:smoke", get_config(a, smoke=True)) for a in all_archs()]
    if not args.smoke_only:
        runs += [(f"{a}:full", get_config(a).with_overrides(**kw))
                 for a, kw in FULL.items()]
    out = {"device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else "cpu"),
           "torch": torch.__version__,
           "digests": {name: digest(cfg, args.device) for name, cfg in runs}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
