"""Lookup (prompt n-gram) and draft-model speculative decoding (the port of
``tmac_tpu/runtime/speculative.py``).

The reference runs a whole generation as one jitted ``lax.while_loop``:
the proposal, the k-token verification forward, the acceptance scan and
the cache rewind, with no host round trip.  A CUDA graph cannot loop on
data, so the port captures ONE round (propose, verify, accept, emit into
fixed buffers, rewind ``pos`` in place; for the draft variant also the k
draft forwards and both rewinds) and replays it in bursts.  A burst
replays ``burst_rounds`` rounds: the most that can neither pass the token
budget nor run past the cache's rows whatever the round accepts, so every
replayed round is one the reference's ``cond`` would run.  After a burst
one small device-to-host read of (emitted, length) decides the next; the
rounds themselves hold no ``.item()``, no data-dependent shape and no host
branch on device values.  On the card the first round runs eagerly on a
side stream (capture's warm-up; the generator registered), the capture
follows, and the graph replays; a failed capture raises and never falls
back to the eager rounds.  A model on the CPU runs the same rounds eagerly
in bursts of the same size.

Greedy (temperature <= 0): the emitted stream is the model's own greedy
choices, whatever the draft, since verification recomputes the argmax at
every position and keeps only matching prefixes.  Note that the
verification forward sums in other orders than a one-token step (the
T > 1 attention is the masked einsum, not the decode kernel; the rows
change K1's plan and torch's reductions), so at a near-tie its stream may
part from decode_loop's, as the reference's may from its own.
temperature > 0: speculative rejection sampling (_sampled_accept,
arXiv:2211.17192): the stream is another draw of the same distribution as
the plain sampler's.  Draws come from the caller's ``torch.Generator``;
nothing draws from the global one.

Cache: a verification forward writes K/V for all k+1 fed tokens; the
rejected rows hold stale entries, but pos is rewound to just past the
accepted prefix, attention masks rows after each position, and the next
verification overwrites exactly that stale span before reading it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.runtime.generate import (_capture, _check_impl,
                                             check_prompt_ids, prefill)
from tmac_tpu_torch.runtime.sampling import (SamplerConfig, _categorical,
                                             filtered_logits, sample)


def burst_rounds(steps: int, emitted: int, length: int, S: int, k: int,
                 per_round: int) -> int:
    """The rounds the next burst may run without a host check: each of
    them must find the reference's cond true (emitted < steps and length +
    k + 1 <= S) however many tokens the rounds before it emit, from 1 to
    per_round (k + 1 for lookup, k for the draft variant).  So r rounds
    with r <= ceil((steps - emitted) / per_round) (the first r - 1 emit
    fewer than the remaining budget) and r <= (S - length) // (k + 1)
    (each advances length by at most k + 1).  0 ends the run."""
    return max(0, min(-(-(steps - emitted) // per_round), (S - length) // (k + 1)))


def _propose_ngram(buf: torch.Tensor, length, n: int, k: int):
    """Most-recent-match n-gram proposal from the token buffer.

    buf (S,) holds the sequence so far in [0, length) (length an int or a
    (1,) tensor on buf's device); the draft is the k tokens that followed
    the most recent earlier occurrence of the trailing n-gram, continued
    cyclically with the match's period (a recent match would otherwise
    draft past the known tokens).  Returns (draft (k,), found (bool
    tensor)), the draft -1 where nothing was found."""
    S, dev = buf.shape[0], buf.device
    if not torch.is_tensor(length):
        length = torch.tensor([length], device=dev)
    length = length.reshape(1).long()
    ar_n = torch.arange(n, device=dev)
    ngram = buf.index_select(0, (length - n).clamp_min(0) + ar_n)
    pos = torch.arange(S - n + 1, device=dev)
    windows = buf[pos[:, None] + ar_n[None, :]]               # (S-n+1, n)
    match = (windows == ngram[None, :]).all(1)
    # any occurrence strictly before the trailing one (overlaps allowed:
    # they encode short periods, e.g. a constant stream)
    ok = match & (pos < length - n)
    j = torch.where(ok, pos, -1).max()
    found = j >= 0
    p = ((length - n) - j).clamp_min(1)
    src = length - p + torch.arange(k, device=dev) % p
    draft = buf.index_select(0, src.clamp(0, S - 1))
    return torch.where(found, draft, -1), found


def _leading_true(mask: torch.Tensor) -> torch.Tensor:
    """The count of leading True entries of a (k,) bool tensor, as (1,):
    the index of the first False (k when none)."""
    return mask.long().cumprod(0).sum().reshape(1)


def _sampled_accept(logits: torch.Tensor, draft: torch.Tensor, generator,
                    cfg: SamplerConfig, q_probs: Optional[torch.Tensor] = None):
    """Speculative rejection sampling targeting p_i =
    softmax(filtered_logits(logits_i)) (Leviathan et al. 2023).

    logits (k+1, V); draft (k,) (-1 = no proposal, never accepted);
    q_probs (k, V): the draft model's proposal distribution, or None for a
    deterministic draft (q a point mass at draft[i]: accept with p_i(d_i),
    residual p_i without d_i).  generator: the torch.Generator of the
    uniforms and of the correction's draw.  Each argument may carry a
    leading batch dimension B (independent trials, one draw each).

    Returns (tokens (k+1,), a (1,)), or ((B, k+1), (B,)): tokens[:a] the
    accepted draft tokens, tokens[a] the correction (a < k: drawn from
    norm(max(p - q, 0))) or the bonus (a == k: drawn from p_k).  Emitting
    any prefix of tokens[:a+1] keeps the target distribution at every
    position."""
    single = logits.dim() == 2
    if single:
        logits, draft = logits[None], draft[None]
        q_probs = None if q_probs is None else q_probs[None]
    B, k, V = draft.shape[0], draft.shape[1], logits.shape[-1]
    dev = logits.device
    p = torch.softmax(filtered_logits(logits, cfg), dim=-1)      # (B, k+1, V)
    d_ix = draft.clamp_min(0).long()
    p_d = p[:, :k].gather(2, d_ix[..., None])[..., 0]             # (B, k)
    if q_probs is None:
        ratio = p_d                                               # q(d_i) = 1
    else:
        ratio = p_d / q_probs.gather(2, d_ix[..., None])[..., 0].clamp_min(1e-20)
    u = torch.rand((B, k), generator=generator, device=dev)
    # the first rejected position: the count of leading acceptances
    a = ((u < ratio) & (draft >= 0)).long().cumprod(1).sum(1)     # (B,)
    p_a = p.gather(1, a[:, None, None].expand(B, 1, V))[:, 0]     # (B, V)
    a_c = a.clamp_max(k - 1)[:, None]
    if q_probs is None:
        # remove the rejected proposal, but only where one existed: a
        # no-proposal round was never rejected by the coin, so its
        # correction is a plain draw from p_a
        had = (draft.gather(1, a_c) >= 0).to(p.dtype)
        hit = (torch.arange(V, device=dev)[None, :] == d_ix.gather(1, a_c)).to(p.dtype)
        res = p_a * (1.0 - had * hit)
    else:
        q_a = q_probs.gather(1, a_c[..., None].expand(B, 1, V))[:, 0]
        res = (p_a - q_a).clamp_min(0.0)
    res = torch.where((a == k)[:, None], p_a, res)  # all accepted: bonus from p_k
    tot = res.sum(-1, keepdim=True)
    # a degenerate residual (p <= q everywhere, underflow) falls back to
    # p_a, still a valid draw of the target at position a
    res = torch.where(tot > 1e-20, res / tot.clamp_min(1e-20), p_a)
    corr = _categorical(generator, torch.log(res.clamp_min(1e-30)))
    idx = torch.arange(k + 1, device=dev)[None, :]
    dpad = torch.cat([d_ix, torch.zeros((B, 1), dtype=torch.long, device=dev)], 1)
    tokens = torch.where(idx < a[:, None], dpad, 0)
    tokens = torch.where(idx == a[:, None], corr[:, None], tokens)
    return (tokens[0], a) if single else (tokens, a)


class _Run:
    """The device state of one speculative run at fixed addresses, so that
    a CUDA graph of a round reads and writes it: the token buffer, the
    output, and (emitted, length, target forwards, draft forwards) as one
    int64 tensor; the burst loop; on the card the graph of the round,
    captured at first need and kept for later runs on the same buffers
    (the engine's chunks)."""

    per_round = 0   # the most tokens a round emits

    def __init__(self, cache: KVCache, steps: int, k: int, sampler: SamplerConfig,
                 generator, buf_len: int):
        dev = cache.pos.device
        self.cache, self.steps, self.k = cache, steps, k
        self.sampler, self.generator = sampler, generator
        self.S = cache.max_len
        self.buf = torch.zeros((max(self.S, buf_len),), dtype=torch.long, device=dev)
        self.out = torch.zeros((steps + k + 1,), dtype=torch.int32, device=dev)
        self.ints = torch.zeros((4,), dtype=torch.long, device=dev)
        self.emitted, self.length = self.ints[0:1], self.ints[1:2]
        self.idx = torch.arange(k + 1, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _emit(self, emit_src: torch.Tensor, ntok: torch.Tensor, pos0) -> None:
        """Emit emit_src[:ntok] ((1,) tensor, clamped to the budget and to
        at least 1) into out and buf, move emitted and length on, and
        rewind every cache of pos0 [(cache, its pos before the round)] to
        pos0 + ntok, in place: the next real input is the last emitted
        token, at that position."""
        ntok = torch.minimum(ntok, self.steps - self.emitted).clamp_min(1)
        emit = torch.where(self.idx < ntok, emit_src, 0)
        self.out.index_copy_(0, self.emitted + self.idx, emit.to(torch.int32))
        self.buf.index_copy_(0, self.length + self.idx, emit.long())
        for cache, p0 in pos0:
            cache.pos.copy_(p0 + ntok)
        self.emitted.add_(ntok)
        self.length.add_(ntok)

    def round(self) -> None:
        raise NotImplementedError

    def start(self, history: torch.Tensor, history_len: int) -> None:
        """Fill the buffers for a run from history (1, Sh), whose token at
        history_len - 1 counts as emitted (out[0])."""
        Sh = history.shape[1]
        if history.shape[0] != 1:
            raise ValueError("speculative decode is single-stream (B == 1)")
        if not 1 <= history_len <= min(Sh, self.S):
            raise ValueError(f"history_len {history_len} outside [1, "
                             f"{min(Sh, self.S)}]")
        self.buf.zero_()
        self.buf[:Sh].copy_(history[0])
        self.out.zero_()
        self.out[:1].copy_(self.buf[history_len - 1:history_len])
        self.ints.copy_(torch.tensor([1, history_len, 0, 0]))

    def drive(self, graph: bool, stats: Optional[dict] = None) -> list:
        """Run bursts of rounds until burst_rounds gives 0: on the card
        (graph) replays of the round's CUDA graph (captured at first need,
        its warm-up a real round), else eager rounds.  One read of the
        counters a burst.  -> [emitted, length, target forwards, draft
        forwards]."""
        t0 = time.perf_counter()
        st = dict(graph=graph, replays=0, bursts=0, eager_rounds=0, host_syncs=0,
                  setup_s=0.0, replay_events=[], captured=False)
        while True:
            ints = self.ints.tolist()          # the one host read a burst
            st["host_syncs"] += 1
            r = burst_rounds(self.steps, ints[0], ints[1], self.S, self.k,
                             self.per_round)
            if r == 0:
                break
            st["bursts"] += 1
            if not graph or (self.graph is None and r == 1):
                for _ in range(r):
                    self.round()
                st["eager_rounds"] += r
                continue
            if self.graph is None:
                self.graph = _capture(self.round, self.generator, self.buf.device)
                st.update(captured=True, setup_s=time.perf_counter() - t0)
                st["eager_rounds"] += 1
                r -= 1
                if r == 0:
                    continue
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(r):
                self.graph.replay()
            stop.record()
            st["replays"] += r
            st["replay_events"].append((start, stop))
        if stats is not None:
            stats.update(st)
        return ints

    def run(self, history: torch.Tensor, history_len: int,
            graph: Optional[bool] = None, stats: Optional[dict] = None):
        """-> (tokens (1, steps) int32 with the seed token first, emitted,
        target forwards, draft forwards)."""
        self.start(history, history_len)
        if graph is None:
            graph = self.buf.device.type == "cuda"
        emitted, _, nft, nfd = self.drive(graph, stats)
        return self.out[None, :self.steps], emitted, nft, nfd


class _LookupRun(_Run):
    """Lookup speculation: the n-gram proposal, one verification forward of
    the last token and the k drafts, acceptance, emit, rewind."""

    def __init__(self, model: Llama, cache: KVCache, steps: int, ngram: int,
                 k: int, sampler: SamplerConfig, generator, buf_len: int):
        super().__init__(cache, steps, k, sampler, generator, buf_len)
        self.model, self.ngram = model, ngram
        self.per_round = k + 1

    def round(self) -> None:
        k = self.k
        draft, _ = _propose_ngram(self.buf, self.length, self.ngram, k)
        last = self.buf.index_select(0, self.length - 1)
        feed = torch.cat([last, draft.clamp_min(0)])[None, :]         # (1, k+1)
        pos0 = self.cache.pos.clone()
        logits, _ = self.model(feed, self.cache)
        if self.sampler.temperature > 0.0:
            emit_src, a = _sampled_accept(logits[0], draft, self.generator,
                                          self.sampler)
        else:
            emit_src = torch.argmax(logits[0].float(), dim=-1)       # y_0..y_k
            # the longest draft prefix that matches the model's own choices
            a = _leading_true(draft == emit_src[:k])
        self._emit(emit_src, a + 1, [(self.cache, pos0)])
        self.ints[2:3].add_(1)


class _DraftRun(_Run):
    """Draft-model speculation: k draft forwards (greedy, or drawn from the
    draft's own filtered distribution, which is then reported to the
    acceptance test), one target verification forward, acceptance capped
    at k (the bonus token's draft K/V was never computed, so both caches
    rewind by one formula), emit, both rewinds."""

    def __init__(self, model_t: Llama, model_d: Llama, cache_t: KVCache,
                 cache_d: KVCache, steps: int, k: int, sampler: SamplerConfig,
                 generator, buf_len: int):
        super().__init__(cache_t, steps, k, sampler, generator, buf_len)
        self.model_t, self.model_d, self.cache_d = model_t, model_d, cache_d
        self.per_round = k

    def round(self) -> None:
        k, sampled = self.k, self.sampler.temperature > 0.0
        last = self.buf.index_select(0, self.length - 1)
        pos0_t, pos0_d = self.cache.pos.clone(), self.cache_d.pos.clone()
        tok, drafts, qrows = last, [], []
        for _ in range(k):
            lg, _ = self.model_d(tok[None, :], self.cache_d)
            lg = lg[0, -1]
            if sampled:
                fl = filtered_logits(lg, self.sampler)
                nxt = _categorical(self.generator, fl[None])
                qrows.append(torch.softmax(fl, dim=-1))
            else:
                nxt = torch.argmax(lg.float(), dim=-1, keepdim=True)
            drafts.append(nxt)
            tok = nxt
        draft = torch.cat(drafts)
        feed = torch.cat([last, draft])[None, :]                      # (1, k+1)
        logits, _ = self.model_t(feed, self.cache)
        if sampled:
            emit_src, a = _sampled_accept(logits[0], draft, self.generator,
                                          self.sampler, q_probs=torch.stack(qrows))
        else:
            emit_src = torch.argmax(logits[0].float(), dim=-1)
            a = _leading_true(draft == emit_src[:k])
        self._emit(emit_src, (a + 1).clamp_max(k),
                   [(self.cache, pos0_t), (self.cache_d, pos0_d)])
        self.ints[2:3].add_(1)
        self.ints[3:4].add_(k)


def _history(prompt: torch.Tensor, first: torch.Tensor, S: int) -> torch.Tensor:
    """(1, max(S, T + 1)) history: the prompt (1, T), then first (1,)."""
    T = prompt.shape[1]
    hist = torch.zeros((1, max(S, T + 1)), dtype=torch.long, device=prompt.device)
    hist[:, :T] = prompt
    hist[:, T] = first
    return hist


@torch.no_grad()
def decode_chunk_speculative(model: Llama, history: torch.Tensor, history_len: int,
                             cache: KVCache, steps: int, ngram: int = 3,
                             k: int = 8, sampler: SamplerConfig = SamplerConfig(),
                             generator: Optional[torch.Generator] = None,
                             stats: Optional[dict] = None,
                             graph: Optional[bool] = None):
    """Decode `steps` tokens with lookup speculation.

    history (1, Sh), zero-padded: every token so far; the last
    (history[0, history_len - 1]) counts as emitted and comes back first.
    The cache must hold K/V for history[:history_len - 1] with pos ==
    history_len - 1; it is updated in place.  temperature > 0 takes
    rejection sampling with `generator`.  graph: None runs graph bursts on
    a model on the card and eager rounds elsewhere; False eager rounds on
    any device (what the graph is held to).  stats, a dict, receives
    "graph", "replays", "bursts", "eager_rounds", "host_syncs",
    "captured", "setup_s" (host seconds before the first replay) and
    "replay_events" (a pair of CUDA events around each burst's replays).

    Returns (tokens (1, steps) int32 with the seed token first, n_emitted
    (<= steps; short only when the cache is nearly full), n_forwards,
    cache); the counts are Python ints."""
    if sampler.temperature > 0.0 and generator is None:
        raise ValueError("speculative sampling needs a torch.Generator")
    run = _LookupRun(model, cache, steps, ngram, k, sampler, generator,
                     history.shape[1])
    toks, emitted, nf, _ = run.run(history, history_len, graph, stats)
    return toks, emitted, nf, cache


@torch.no_grad()
def decode_loop_speculative(model: Llama, first_token: torch.Tensor,
                            cache: KVCache, prompt: torch.Tensor, steps: int,
                            ngram: int = 3, k: int = 8, **kw):
    """One-shot form: prompt (1, T) and the first generated token (1,)
    (prefill's argmax) -> (tokens (1, steps), n_forwards, cache)."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative decode is single-stream (B == 1)")
    hist = _history(prompt.to(cache.pos.device), first_token, cache.max_len)
    out, _, nf, cache = decode_chunk_speculative(
        model, hist, prompt.shape[1] + 1, cache, steps, ngram=ngram, k=k, **kw)
    return out, nf, cache


@torch.no_grad()
def decode_chunk_draft_speculative(model_t: Llama, model_d: Llama,
                                   history: torch.Tensor, history_len: int,
                                   cache_t: KVCache, cache_d: KVCache, steps: int,
                                   k: int = 4,
                                   sampler: SamplerConfig = SamplerConfig(),
                                   generator: Optional[torch.Generator] = None,
                                   stats: Optional[dict] = None,
                                   graph: Optional[bool] = None):
    """Decode `steps` tokens with a draft model proposing k tokens a round.

    Both caches (the same max_len) hold K/V for history[:history_len - 1]
    with pos == history_len - 1, and are updated in place; history, graph
    and stats as decode_chunk_speculative's.  Returns (tokens (1, steps),
    n_emitted, n_target_forwards, n_draft_forwards, cache_t, cache_d)."""
    if model_t.cfg.vocab_size != model_d.cfg.vocab_size:
        raise ValueError(f"the draft's vocabulary ({model_d.cfg.vocab_size}) "
                         f"is not the target's ({model_t.cfg.vocab_size})")
    if cache_t.max_len != cache_d.max_len:
        raise ValueError("the target's and the draft's caches differ in rows")
    if sampler.temperature > 0.0 and generator is None:
        raise ValueError("speculative sampling needs a torch.Generator")
    run = _DraftRun(model_t, model_d, cache_t, cache_d, steps, k, sampler,
                    generator, history.shape[1])
    toks, emitted, nft, nfd = run.run(history, history_len, graph, stats)
    return toks, emitted, nft, nfd, cache_t, cache_d


def _prompt(model: Llama, prompt_tokens) -> torch.Tensor:
    """The prompt as a (1, T) long tensor on the model's device."""
    pt = check_prompt_ids(prompt_tokens, model.cfg.vocab_size)
    if pt.ndim == 1:
        pt = pt[None, :]
    if pt.shape[0] != 1:
        raise ValueError("speculative decode is single-stream (B == 1)")
    return torch.from_numpy(pt.astype(np.int64)).to(model.device)


def _first(logits: torch.Tensor, sampler: SamplerConfig, gen) -> torch.Tensor:
    if sampler.temperature > 0.0:
        return sample(logits, gen, sampler)
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


@torch.no_grad()
def generate_speculative(model: Llama, prompt_tokens, max_new_tokens: int,
                         max_len: Optional[int] = None, ngram: int = 3, k: int = 8,
                         impl: str = "auto", sampler: SamplerConfig = SamplerConfig(),
                         seed: int = 0, stats: Optional[dict] = None,
                         graph: Optional[bool] = None):
    """Prefill + lookup-speculative decode (greedy, or rejection sampling at
    temperature > 0 with a torch.Generator seeded by `seed`) on the
    model's device.  impl as generate's; stats and graph as
    decode_chunk_speculative's.  The cache has max_len rows (default T +
    max_new_tokens + k + 1, rounded up to 128 by KVCache.create).
    Returns (tokens (1, max_new_tokens) int32, n_forwards)."""
    _check_impl(model, impl)
    toks = _prompt(model, prompt_tokens)
    T = toks.shape[1]
    S = max_len or (T + max_new_tokens + k + 1)
    cache = KVCache.create(model.cfg, 1, S, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    logits, cache = prefill(model, toks, cache)
    first = _first(logits, sampler, gen)
    out, _, nf, _ = decode_chunk_speculative(
        model, _history(toks, first, cache.max_len), T + 1, cache,
        max_new_tokens, ngram=ngram, k=k, sampler=sampler, generator=gen,
        stats=stats, graph=graph)
    return out, nf


@torch.no_grad()
def generate_draft_speculative(model_t: Llama, model_d: Llama, prompt_tokens,
                               max_new_tokens: int, max_len: Optional[int] = None,
                               k: int = 4, impl: str = "auto",
                               sampler: SamplerConfig = SamplerConfig(),
                               seed: int = 0, stats: Optional[dict] = None,
                               graph: Optional[bool] = None):
    """Prefill both models + draft-speculative decode; the arguments as
    generate_speculative's.  Returns (tokens (1, max_new_tokens) int32,
    n_target_forwards, n_draft_forwards)."""
    _check_impl(model_t, impl)
    _check_impl(model_d, impl)
    if model_t.cfg.vocab_size != model_d.cfg.vocab_size:
        raise ValueError(f"the draft's vocabulary ({model_d.cfg.vocab_size}) "
                         f"is not the target's ({model_t.cfg.vocab_size})")
    toks = _prompt(model_t, prompt_tokens)
    T = toks.shape[1]
    S = max_len or (T + max_new_tokens + k + 1)
    cache_t = KVCache.create(model_t.cfg, 1, S, device=model_t.device)
    cache_d = KVCache.create(model_d.cfg, 1, S, device=model_d.device)
    gen = torch.Generator(device=model_t.device).manual_seed(seed)
    logits, cache_t = prefill(model_t, toks, cache_t)
    _, cache_d = prefill(model_d, toks, cache_d)
    first = _first(logits, sampler, gen)
    out, _, nft, nfd, _, _ = decode_chunk_draft_speculative(
        model_t, model_d, _history(toks, first, cache_t.max_len), T + 1,
        cache_t, cache_d, max_new_tokens, k=k, sampler=sampler, generator=gen,
        stats=stats, graph=graph)
    return out, nft, nfd
