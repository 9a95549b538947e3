"""Serving step builders (the port of the prefill and decode parts of
:mod:`repro.launch.steps`). The train step and the sharding helpers
belong to the training slice (ROADMAP.md, queue 1 item 14)."""
from __future__ import annotations

from repro_torch.models import transformer as T


def make_prefill_step(cfg):
    """(params, batch) -> the last position's logits (B, V_pad)."""
    def prefill(params, batch):
        logits, _ = T.forward(params, batch, cfg)
        return logits[:, -1, :]

    return prefill


def make_decode_step(cfg):
    """(params, cache, batch, pos) -> (logits (B,1,V_pad), cache)."""
    def decode(params, cache, batch, pos):
        return T.decode_step(params, cache, batch, pos, cfg)

    return decode
