"""Architecture registry: ``--arch <id>`` -> config module."""
from __future__ import annotations

import importlib

ARCHS: dict[str, str] = {
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
}


def _module(arch: str):
    key = arch.replace("_", "-").lower()
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[key])


def get_config(arch: str, smoke: bool = False):
    m = _module(arch)
    return m.make_smoke_config() if smoke else m.make_config()


def all_archs() -> list[str]:
    return list(ARCHS)
