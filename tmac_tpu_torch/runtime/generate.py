"""Prefill + decode loops (the port of ``tmac_tpu/runtime/generate.py``).

The reference decodes with an on-device ``lax.scan``, so the host never
round-trips per token.  The port's counterpart is a CUDA graph: on a model
that lies on the card, ``decode_loop`` runs the loop's first step eagerly
(which also warms up every kernel and allocation), captures the step once
(the model's forward, the penalties, the draw and the counts, exactly as
the reference's scan body) and replays it for the remaining steps.  A
model on the CPU runs the same step eagerly.  Which of the two runs is
decided by the model's device alone; a capture or replay that fails
raises, and never falls back to the eager loop.  The prefill stays eager
(Mixtral's capacity dispatch waits for the host).  The cache is updated in
place (see models.llama.KVCache).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.runtime.sampling import (Generators, SamplerConfig,
                                             apply_penalties, bump_counts,
                                             sample)


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
                sampler: SamplerConfig = SamplerConfig(),
                generator: Optional[Generators] = None):
    """One token for every sequence: (B,) -> (B,)."""
    logits, cache = model(last_tokens[:, None], cache)
    return sample(logits[:, -1, :], generator, sampler), cache


def _step(model: Llama, tok: torch.Tensor, cache: KVCache,
          sampler: SamplerConfig, generator, counts) -> torch.Tensor:
    """The reference's scan body: forward, penalties, draw, counts."""
    logits, _ = model(tok[:, None], cache)
    lg = logits[:, -1, :]
    if counts is not None:
        lg = apply_penalties(lg, counts, sampler.repeat_penalty,
                             sampler.presence_penalty,
                             sampler.frequency_penalty)
    nxt = sample(lg, generator, sampler)
    if counts is not None:
        bump_counts(counts, nxt)
    return nxt


@torch.no_grad()
def decode_loop(model: Llama, first_tokens: torch.Tensor, cache: KVCache,
                steps: int, sampler: SamplerConfig = SamplerConfig(),
                generator: Optional[Generators] = None,
                stats: Optional[dict] = None):
    """Generate `steps` tokens after first_tokens (B,); returns
    (tokens (B, steps) int32, cache).

    On a model on the card, step 1 runs eagerly and steps 2.. replay one
    captured CUDA graph of it.  The penalties' counts start with
    first_tokens counted, as in the reference.  stats, a dict, receives
    what the run did: "graph" (whether it replayed a graph), "replays",
    "setup_s" (host seconds before the first replay: the eager step, the
    capture and its instantiation) and, for a graph, "replay_events", two
    CUDA events recorded around the replays (read them after a
    synchronize)."""
    B, dev = first_tokens.shape[0], first_tokens.device
    t0 = time.perf_counter()
    counts = None
    if sampler.has_penalties:
        counts = bump_counts(torch.zeros((B, model.cfg.vocab_size),
                                         dtype=torch.int32, device=dev),
                             first_tokens)
    out = torch.empty((B, steps), dtype=torch.int32, device=dev)
    tok = first_tokens.to(torch.int32).clone()   # the step's input buffer
    col = torch.zeros((1,), dtype=torch.long, device=dev)  # next column

    def step():
        nxt = _step(model, tok, cache, sampler, generator, counts)
        out.index_copy_(1, col, nxt[:, None])
        tok.copy_(nxt)
        col.add_(1)

    use_graph = model.device.type == "cuda" and steps > 1
    if stats is not None:
        stats.update(graph=use_graph, replays=0)
    if not use_graph:
        for _ in range(steps):
            step()
        return out, cache
    graph = _capture(step, generator, dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    setup_s = time.perf_counter() - t0
    start.record()
    for _ in range(steps - 1):
        graph.replay()
    stop.record()
    if stats is not None:
        stats.update(replays=steps - 1, setup_s=setup_s,
                     replay_events=(start, stop))
    return out, cache


def _capture(step, generator: Optional[Generators],
             device: torch.device) -> torch.cuda.CUDAGraph:
    """Run step() once eagerly on a side stream (the warm-up that capture
    asks for, and the loop's first step), then capture it in a CUDA graph
    on `device` with the generators registered: without that a
    non-default generator's replays would repeat one draw (its capture
    raises)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gens = [] if generator is None else (
            [generator] if isinstance(generator, torch.Generator) else generator)
        for g in gens:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            step()
    return graph


def _check_impl(model: Llama, impl: str) -> None:
    """impl as the reference names it: "auto" and "pallas" run the kernels,
    "xla" the plain versions (a model made with plain=True).  The model
    decides what runs, so a mismatch raises rather than switching."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl {impl!r}: one of auto, pallas, xla")
    if (impl == "xla") != model.plain:
        raise ValueError(
            f"impl={impl!r} on a model made with plain={model.plain}: "
            "impl='xla' takes a model made with plain=True, 'auto' and "
            "'pallas' one without")


def check_prompt_ids(prompt_tokens, vocab: int) -> np.ndarray:
    """The prompt as numpy, its ids checked against the vocabulary (an id
    past it would be a device-side fault in the embedding)."""
    pt = np.asarray(prompt_tokens)
    if pt.max(initial=0) >= vocab or pt.min(initial=0) < 0:
        raise ValueError(f"prompt token ids out of range [0, {vocab})")
    return pt


def generate(model: Llama, prompt_tokens, max_new_tokens: int,
             max_len: Optional[int] = None,
             sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
             impl: str = "auto", batch: Optional[int] = None,
             kv_quant: bool = False) -> torch.Tensor:
    """Prefill + decode_loop on the model's device -> (B, max_new_tokens)
    int32.  seed seeds the one torch.Generator of the draws; impl: see
    _check_impl; batch, when given, must equal the prompt's rows (the
    reference takes the argument and ignores it).  kv_quant: an int8 KV
    cache (KVCache quant mode, half the KV bytes).

    The cache has the reference's rows: max_len (default T +
    max_new_tokens) rounded up to 64, then to 128 by KVCache.create.  A
    request needs T + max_new_tokens - 1 of them (the last token is drawn,
    never written); past them the reference's writes clamp to the last
    row and give no meaningful tokens, and the port refuses instead."""
    _check_impl(model, impl)
    cfg = model.cfg
    pt = check_prompt_ids(prompt_tokens, cfg.vocab_size)
    B, T = pt.shape
    if batch is not None and batch != B:
        raise ValueError(f"batch={batch} but the prompt has {B} rows")
    max_len = -(-(max_len or (T + max_new_tokens)) // 64) * 64
    cache = KVCache.create(cfg, B, max_len, device=model.device,
                           quant=kv_quant)
    if T + max_new_tokens - 1 > cache.max_len:
        raise ValueError(f"{T} + {max_new_tokens} tokens need "
                         f"{T + max_new_tokens - 1} cache rows; the cache "
                         f"has {cache.max_len}")
    gen = torch.Generator(device=model.device).manual_seed(seed)
    tokens = torch.from_numpy(pt.astype(np.int64)).to(model.device)
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits, gen, sampler)
    toks, cache = decode_loop(model, first, cache, max_new_tokens - 1,
                              sampler, gen)
    return torch.cat([first[:, None], toks], dim=1)
