"""Prefill + decode loops (the port of ``tmac_tpu/runtime/generate.py``).

Eager PyTorch: every decode step is a Python-level call of the model, so
each of its kernels is launched from the host (a CUDA-graph-captured step
is later work).  The cache is updated in place (see models.llama.KVCache).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.runtime.sampling import SamplerConfig, sample


@torch.no_grad()
def prefill(model: Llama, tokens: torch.Tensor, cache: KVCache,
            chunk: int = 256):
    """Run the prompt (B, T) in `chunk`-token pieces; returns
    (last-position logits (B, V), cache)."""
    logits = None
    for off in range(0, tokens.shape[1], chunk):
        logits, cache = model(tokens[:, off:off + chunk], cache)
    return logits[:, -1, :], cache


@torch.no_grad()
def decode_step(model: Llama, last_tokens: torch.Tensor, cache: KVCache,
                sampler: SamplerConfig = SamplerConfig()):
    """One token for every sequence: (B,) -> (B,)."""
    logits, cache = model(last_tokens[:, None], cache)
    return sample(logits[:, -1, :], sampler), cache


@torch.no_grad()
def decode_loop(model: Llama, first_tokens: torch.Tensor, cache: KVCache,
                steps: int, sampler: SamplerConfig = SamplerConfig()):
    """Generate `steps` tokens; returns (tokens (B, steps), cache)."""
    tok, toks = first_tokens, []
    for _ in range(steps):
        tok, cache = decode_step(model, tok, cache, sampler)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def generate(model: Llama, prompt_tokens, max_new_tokens: int,
             max_len: Optional[int] = None,
             sampler: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Prefill + decode_loop on the model's device -> (B, max_new_tokens)."""
    cfg = model.cfg
    pt = np.asarray(prompt_tokens)
    if pt.max(initial=0) >= cfg.vocab_size or pt.min(initial=0) < 0:
        raise ValueError(f"prompt token ids out of range [0, {cfg.vocab_size})")
    B, T = pt.shape
    max_len = -(-(max_len or (T + max_new_tokens)) // 64) * 64
    if T + max_new_tokens > max_len:
        raise ValueError(f"{T} + {max_new_tokens} tokens exceed max_len {max_len}")
    cache = KVCache.create(cfg, B, max_len, device=model.device)
    tokens = torch.from_numpy(pt.astype(np.int64)).to(model.device)
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits, sampler)
    toks, cache = decode_loop(model, first, cache, max_new_tokens - 1, sampler)
    return torch.cat([first[:, None], toks], dim=1)
