"""Batched LLM serving on the PyTorch/CUDA port, with KV/SSM caches
across three architecture families (dense GQA, sliding-window MoE,
attention-free SSD).

    PYTHONPATH=src python examples/serve_llm_torch.py [--device cpu]

The same three models as ``examples/serve_llm.py``, each at its reduced
smoke config, on ``repro_torch`` and ``--device`` (``cuda`` by
default): greedy serving (its prompts go through the decode path, token
by token, as in the reference), then one prefill of the same prompts
through ``make_prefill_step``, which runs the flash-attention and
SSD-scan kernels (their plain versions on the CPU). Each model's kernel
launches are printed.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as sd
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.models.module import init_params

BATCH, PROMPT, GEN, SEED = 4, 8, 16, 0

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for arch in ("qwen3-14b", "mixtral-8x7b", "mamba2-1.3b"):
        print(f"\n=== {arch} (reduced smoke config) ===")
        fa.reset_launches()
        sd.reset_launches()
        serve_main(["--arch", arch, "--batch", str(BATCH), "--prompt-len",
                    str(PROMPT), "--gen", str(GEN), "--seed", str(SEED),
                    "--device", args.device])
        # the serve CLI's parameters and prompts, prefilled in one step
        cfg = get_config(arch, smoke=True)
        params = init_params(T.specs(cfg), seed=SEED, device=args.device)
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
        with torch.no_grad():
            logits = make_prefill_step(cfg)(
                params, {"tokens": torch.from_numpy(prompts).to(args.device)})
        nxt = logits[:, :cfg.vocab_size].argmax(dim=-1).tolist()
        print(f"prefill of the prompts: next tokens {nxt}")
        print(f"kernel launches: flash_attention {fa.launches}, "
              f"ssd_scan {sd.launches}")
