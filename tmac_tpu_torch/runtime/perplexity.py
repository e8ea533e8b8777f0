"""Perplexity and continuation scoring (the port of
``tmac_tpu/runtime/perplexity.py``).

Each window is one forward over a fresh cache, as in the reference: at a
window of 64 rows or more that runs the prefill kernels (K3 for
per-tensor scales, K4L or, from 3 * group_size rows, K5 for grouped
ones).
"""

from __future__ import annotations

import numpy as np
import torch

from tmac_tpu_torch.models.llama import KVCache, Llama


def _logprobs(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> log p of every next token (B, T - 1, V) f32, from
    one forward over a fresh cache of T rows."""
    cache = KVCache.create(model.cfg, tokens.shape[0], tokens.shape[1],
                           device=model.device)
    logits, _ = model(tokens, cache)
    return torch.log_softmax(logits[:, :-1, :].float(), dim=-1)


@torch.no_grad()
def _window_nll(model: Llama, tokens: torch.Tensor):
    """tokens (1, T): (sum of the T - 1 next-token NLLs, their count)."""
    logp = _logprobs(model, tokens)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return nll.sum(), nll.numel()


def perplexity(model: Llama, token_stream, window: int = 512,
               stride: int | None = None) -> dict:
    """Sliding-window perplexity over a 1-D token stream:
    {"nll", "ppl", "tokens"}, windows of `window` tokens every `stride`
    (default: window), a trailing short window dropped."""
    stride = stride or window
    token_stream = np.asarray(token_stream)
    vocab = model.cfg.vocab_size
    if token_stream.max(initial=0) >= vocab or token_stream.min(initial=0) < 0:
        raise ValueError(f"token ids out of range [0, {vocab})")
    total, count = 0.0, 0
    T = len(token_stream)
    for start in range(0, max(T - window, 0) + 1, stride):
        chunk = token_stream[start:start + window]
        if len(chunk) < window:
            break
        s, c = _window_nll(model, torch.from_numpy(
            chunk[None].astype(np.int64)).to(model.device))
        total += float(s)
        count += int(c)
    if count == 0:
        raise ValueError(f"token stream too short ({T} < window {window})")
    nll = total / count
    return {"nll": nll, "ppl": float(np.exp(nll)), "tokens": count}


@torch.no_grad()
def score_continuations(model: Llama, context, continuations) -> list:
    """Teacher-forced log-likelihood of each continuation given a shared
    context (the lm-eval-harness loglikelihood primitive).

    context: list[int]; continuations: list[list[int]].  Returns a list of
    {"logprob": float, "greedy": bool}, `greedy` True iff the continuation
    is exactly the model's argmax decoding.  All continuations go through
    ONE right-padded forward (T rounded up to 8, as in the reference)."""
    context = [int(t) for t in context]
    conts = [[int(t) for t in c] for c in continuations]
    if not context or not all(conts):
        raise ValueError("context and continuations must be non-empty")
    B = len(conts)
    T = len(context) + max(len(c) for c in conts)
    T = -(-T // 8) * 8
    toks = np.zeros((B, T), np.int64)
    valid = np.zeros((B, T), bool)
    for i, c in enumerate(conts):
        row = context + c
        toks[i, :len(row)] = row
        valid[i, len(context):len(row)] = True
    tokens = torch.from_numpy(toks).to(model.device)
    v = torch.from_numpy(valid[:, 1:]).to(model.device)
    logp = _logprobs(model, tokens)
    tgt = tokens[:, 1:]
    tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    greedy = torch.argmax(logp, dim=-1) == tgt
    lp = torch.where(v, tok_lp, 0.0).sum(-1).tolist()
    ok = (greedy | ~v).all(-1).tolist()
    return [{"logprob": float(lp[i]), "greedy": bool(ok[i])}
            for i in range(B)]
