"""LM serving driver: prefill + batched greedy decode (mirrors
``repro.launch.legacy.serve``) at an LM arch's smoke overrides.

The weights are ``init_params(PRNGKey(seed))`` and the prompts
``randint(fold_in(PRNGKey(seed), 1), (batch, prompt_len), 0, vocab)``,
the reference's; the driver prefills with ``max_len = prompt_len +
gen_tokens`` and decodes ``gen_tokens - 1`` steps, each taking the argmax
of the last logits. On the card unless ``--device cpu``.

Usage:
  python -m repro_torch.launch.legacy.serve --arch qwen3-4b --tokens 32 \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ... import random as trandom
from ...configs import get_arch
from ...device import DEFAULT_DEVICE, resolve_device
from ...legacy.models import transformer as tfm


def serve(arch_name: str, *, batch: int = 4, prompt_len: int = 32,
          gen_tokens: int = 32, seed: int = 0, verbose: bool = True,
          device=DEFAULT_DEVICE) -> torch.Tensor:
    """Generate ``gen_tokens`` greedy tokens after random prompts → the ids,
    ``(batch, gen_tokens)`` int32 on ``device``."""
    arch = get_arch(arch_name)
    if arch.family != "lm":
        raise ValueError(f"{arch_name}: the serve driver takes an LM arch, "
                         f"not a {arch.family} one")
    cfg = dataclasses.replace(arch.model, **arch.smoke)
    key = trandom.PRNGKey(seed, device=resolve_device(device))
    params = tfm.init_params(key, cfg)
    prompts = trandom.randint(trandom.fold_in(key, 1), (batch, prompt_len),
                              0, cfg.vocab)
    max_len = prompt_len + gen_tokens
    with torch.no_grad():
        logits, cache = tfm.prefill(params, prompts, cfg, max_len)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        if tok.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gen_tokens - 1):
            logits, cache = tfm.decode_step(params, cache, tok, cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
        gen = torch.stack(out, 1)
        first = gen[0].tolist()  # waits for the last step
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[serve] {arch_name}: batch={batch} prompt={prompt_len} "
              f"generated={gen.shape[1]} tokens "
              f"({batch * (gen_tokens - 1) / max(dt, 1e-9):.1f} tok/s) on "
              f"{gen.device}")
        print("[serve] first sequence:", first)
    return gen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    serve(args.arch, batch=args.batch, prompt_len=args.prompt,
          gen_tokens=args.tokens, seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
