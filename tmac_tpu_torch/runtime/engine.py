"""Continuous-batching inference engine (the port of
``tmac_tpu/runtime/engine.py``).

A slot-based continuous batcher over one ``Llama`` and a fixed-shape KV
cache, as in the JAX package:

  * a fixed batch of B slots shares one decode step, so admission or
    completion of a request changes only the contents of its inputs (the
    active mask, per-slot positions, sampler vectors), never their shapes;
  * decode runs in chunks of ``decode_chunk`` steps with one host sync a
    chunk; eos and the token budget are checked on the device (a slot that
    finishes freezes mid-chunk) and again host-side, which trims;
  * prefill goes through length buckets (16, then x4, up to
    ``prefill_chunk``), a chunk at a time, interleaved with decode;
  * each slot owns a row of the (L, B, KV, S, Dp) cache with its own
    write position (KVCache.pos is (B,)).

Where the JAX package jits a chunk as one ``while_loop``, the port keeps a
step's inputs and outputs in device buffers at fixed addresses
(``_ChunkBuffers``), and on a model on the card captures ONE step in a
CUDA graph and replays it for the chunk: one graph per variant that JAX
jits separately (a static sampler or per-slot sampler vectors, penalties
on or off, logprob records on or off), each captured at first use or in
``warmup``, all in one memory pool.  The host fills the buffers with one
copy before the replays and reads the tokens with one copy after them.
The whole chunk is replayed: a frozen slot is a no-op in the step (its
pos does not advance; its row is rewritten at the frozen pos, as JAX
writes it), so the tokens are those of JAX's early-exit loop.  A model on
the CPU runs the same step eagerly.  A capture or replay that fails
raises; nothing falls back to the eager loop.  Draws are counter-based
(sampling.CounterStreams): a row's noise is a function of a (seed, index)
pair in the buffers, so seeded and unseeded requests share a graph, and a
seeded request's tokens depend only on its seed and token index.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.runtime.generate import _check_impl
from tmac_tpu_torch.runtime.sampling import (CounterStreams, SamplerConfig,
                                             SamplerState, apply_penalties,
                                             bump_counts, sample,
                                             sample_state)
from tmac_tpu_torch.runtime.speculative import _LookupRun
from tmac_tpu_torch.utils import round_up


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 128
    eos_id: Optional[int] = None
    # per-request sampling overrides (None -> the engine's SamplerConfig),
    # per-slot vectors on the device, so no new graph per setting
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    repeat_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    # stop sequences over GENERATED token ids: when the output ends with
    # any of these, the request finishes and the matched sequence is
    # REMOVED from the output (llama.cpp's stop semantics).  Matched
    # host-side at chunk granularity; text-level stop strings live in
    # runtime/server.py's StopMatcher.
    stop_tokens: Optional[List[List[int]]] = None
    # per-request seed: the request's sampling noise is a pure function of
    # (seed, token index), whatever the batch, slot or other traffic
    seed: Optional[int] = None
    # top alternatives to record per generated token (0 = off; capped at
    # the engine's logprobs_k), log-softmax of the RAW model logits
    logprobs: int = 0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # per generated token, when logprobs > 0:
    # {"logprob": float, "top": [(token_id, logprob), ...]}
    logprobs_out: List[dict] = dataclasses.field(default_factory=list)
    # "eos" | "stop" (stop_tokens match) | "length" | "" (still running)
    finish_reason: str = ""
    prompt_len: int = 0
    # incremental prefill (a request holds its slot while prefilling)
    prefill_off: int = 0
    last_logits: object = None
    prefill_t0: float = 0.0

    def __post_init__(self):
        self.prompt_len = len(self.prompt)

    @property
    def prefilling(self) -> bool:
        return self.prefill_off < self.prompt_len


def prefill_slot(model: Llama, tokens: torch.Tensor, true_len: int,
                 cache: KVCache, slot: int, start_pos: int = 0):
    """Prefill one chunk of a request into cache slot `slot`, in place (the
    single-device prefill, step_fns' first function).

    tokens (1, bucket) right-padded; true_len the chunk's real tokens;
    start_pos the slot position the chunk begins at.  The model runs on a
    KVCache of views of the slot's rows (and scales), so its writes land
    in the batch cache; the padded rows are valid=False (they take no MoE
    dispatch capacity) and write KV past true_len, which later writes
    overwrite, as in JAX.  Returns (the last real position's logits (V,),
    cache) with the slot's pos at start_pos + true_len."""
    dev = tokens.device
    one = slice(slot, slot + 1)
    sub = KVCache(k=cache.k[:, one], v=cache.v[:, one],
                  pos=torch.tensor([start_pos], dtype=torch.int32, device=dev),
                  k_scale=None if cache.k_scale is None else cache.k_scale[:, one],
                  v_scale=None if cache.v_scale is None else cache.v_scale[:, one])
    valid = (torch.arange(tokens.shape[1], device=dev) < true_len)[None, :]
    logits, _ = model(tokens, sub, valid=valid)
    cache.pos[slot] = start_pos + true_len
    return logits[0, true_len - 1], cache


class _ChunkBuffers:
    """A decode chunk's device tensors, at fixed addresses so that a CUDA
    graph of a step reads and writes them: the per-slot inputs the host
    fills before a chunk (ints: last token, active, eos id (-1 = none),
    remaining budget, draw seed, draw index, alive, top-k; floats: the
    other sampler parameters), the column the next token goes to, the
    tokens and logprob records of up to `width` steps, and the penalties'
    counts (made at first use)."""

    INTS = ("tok", "active", "eos", "rem", "seed", "index", "alive", "top_k")
    FLOATS = ("temperature", "top_p", "min_p", "repeat_penalty",
              "presence_penalty", "frequency_penalty")

    def __init__(self, batch: int, vocab: int, width: int, logprobs_k: int,
                 device: torch.device):
        self.vocab, self.device = vocab, device
        self.ints = torch.zeros((len(self.INTS), batch), dtype=torch.int64,
                                device=device)
        self.floats = torch.zeros((len(self.FLOATS), batch), device=device)
        pin = device.type == "cuda"
        self._host_ints = torch.zeros(self.ints.shape, dtype=torch.int64,
                                      pin_memory=pin)
        self._host_floats = torch.zeros(self.floats.shape, pin_memory=pin)
        self.col = torch.zeros((1,), dtype=torch.long, device=device)
        self.out = torch.zeros((batch, width), dtype=torch.int32, device=device)
        self.lp = torch.zeros((batch, width), device=device)
        self.lp_ids = torch.zeros((batch, width, logprobs_k), dtype=torch.int64,
                                  device=device)
        self.lp_vals = torch.zeros((batch, width, logprobs_k), device=device)
        self._counts = None
        # each row of the two tables by name, a view (buf.tok, buf.top_p, ...)
        for table, names in ((self.ints, self.INTS), (self.floats, self.FLOATS)):
            for i, name in enumerate(names):
                setattr(self, name, table[i])

    def counts(self) -> torch.Tensor:
        """The (B, V) int32 counts of the penalties, one buffer for the
        engine's life (a graph with penalties holds its address)."""
        if self._counts is None:
            self._counts = torch.zeros((self.ints.shape[1], self.vocab),
                                       dtype=torch.int32, device=self.device)
        return self._counts

    def state(self) -> SamplerState:
        return SamplerState(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            min_p=self.min_p, repeat_penalty=self.repeat_penalty,
            presence_penalty=self.presence_penalty,
            frequency_penalty=self.frequency_penalty)

    def fill(self, ints: np.ndarray, floats: np.ndarray) -> None:
        """One host-to-device copy of each table (pinned and asynchronous on
        the card; the host touches the staging again only after the
        chunk's token read has synchronized), and the column back to 0."""
        self._host_ints.numpy()[:] = ints
        self._host_floats.numpy()[:] = floats
        nb = self.device.type == "cuda"
        self.ints.copy_(self._host_ints, non_blocking=nb)
        self.floats.copy_(self._host_floats, non_blocking=nb)
        self.col.zero_()


def _decode_step(forward_fn, sampler: SamplerConfig, buf: _ChunkBuffers,
                 cache: KVCache, dynamic: bool, penalized: bool,
                 logprobs_k: int) -> None:
    """One step of the chunk for every slot, in place on buf and cache (the
    body of the JAX package's _decode_chunk_body): a slot runs while it is
    alive (no eos yet), active, inside the cache and within its budget;
    the others are frozen (pos kept, token carried).  dynamic: per-slot
    sampler vectors instead of the static sampler; penalized: penalties
    over buf's counts; logprobs_k > 0: logprob records of the raw logits.
    The draws are CounterStreams(seed, index), and index moves on by 1."""
    act = (buf.alive.bool() & buf.active.bool() & (cache.pos < cache.max_len)
           & (buf.rem > 0))
    tok = buf.tok
    logits, _ = forward_fn(tok[:, None], cache, active=act)
    lg = logits[:, -1, :]
    if logprobs_k:
        logp = torch.log_softmax(lg.float(), dim=-1)
    state = buf.state() if dynamic else None
    if penalized:
        p = state if dynamic else sampler
        lg = apply_penalties(lg, buf.counts(), p.repeat_penalty,
                             p.presence_penalty, p.frequency_penalty)
    streams = CounterStreams(buf.seed, buf.index)
    nxt = sample_state(lg, streams, state) if dynamic \
        else sample(lg, streams, sampler)
    nxt = torch.where(act, nxt, tok.to(torch.int32))
    col = buf.col
    if logprobs_k:
        chosen = logp.gather(-1, nxt.long()[:, None])
        vals, ids = torch.topk(logp, logprobs_k, dim=-1)
        buf.lp.index_copy_(1, col, chosen)
        buf.lp_ids.index_copy_(1, col, ids[:, None])
        buf.lp_vals.index_copy_(1, col, vals[:, None])
    if penalized:
        bump_counts(buf.counts(), nxt, active=act)
    buf.alive.mul_((~(act & (nxt == buf.eos))).long())
    buf.rem.sub_(act.long())
    buf.out.index_copy_(1, col, nxt[:, None])
    tok.copy_(nxt)
    buf.index.add_(1)
    col.add_(1)


def decode_chunk(model: Llama, last_tokens: torch.Tensor, cache: KVCache,
                 steps: int, streams: CounterStreams, active: torch.Tensor,
                 eos_ids: torch.Tensor, remaining: torch.Tensor,
                 state: Optional[SamplerState] = None,
                 counts: Optional[torch.Tensor] = None,
                 sampler: SamplerConfig = SamplerConfig()):
    """The decode chunk as a function, run eagerly (the signature of
    step_fns' second function): `steps` tokens for every active slot.  last_tokens, active, eos_ids, remaining (B,); streams the (B,)
    seeds and draw indices of the chunk's first step; state per-slot
    sampler vectors (else the static sampler); counts (B, V) int32 the
    penalties' tallies, updated in place.  -> (tokens (B, steps), cache),
    and counts after them when given."""
    B, dev = last_tokens.shape[0], last_tokens.device
    buf = _ChunkBuffers(B, model.cfg.vocab_size, steps, 1, dev)
    ints = torch.stack([last_tokens.long(), active.long(), eos_ids.long(),
                        remaining.long(), streams.seed.long(),
                        streams.index.long(), torch.ones_like(active).long(),
                        (state.top_k if state is not None
                         else torch.zeros_like(last_tokens)).long()])
    buf.ints.copy_(ints)
    if state is not None:
        buf.floats.copy_(torch.stack([getattr(state, f).float()
                                      for f in _ChunkBuffers.FLOATS]))
    if counts is not None:
        buf._counts = counts
    for _ in range(steps):
        _decode_step(model, sampler, buf, cache, state is not None,
                     counts is not None, 0)
    out = (buf.out, cache)
    return out + (counts,) if counts is not None else out


def _extract_prefix(cache: KVCache, slot: int, n: int):
    """Copies of the first n positions of `slot`'s rows: k/v (L, 1, KV, n,
    Dp) and, on an int8 cache, the scales (L, 1, KV, n), else None."""
    one = slice(slot, slot + 1)
    return tuple(None if a is None else a[:, one, :, :n].clone()
                 for a in (cache.k, cache.v, cache.k_scale, cache.v_scale))


def _insert_prefix(cache: KVCache, slot: int, entry: "_PrefixEntry") -> None:
    """Write a stored prefix block into `slot`'s rows, in place.  Rows past
    the matched length hold the donor prompt's K/V, which every reader is
    pos-bounded against and the remainder prefill overwrites."""
    one, n = slice(slot, slot + 1), entry.k.shape[3]
    for dst, src in ((cache.k, entry.k), (cache.v, entry.v),
                     (cache.k_scale, entry.ks), (cache.v_scale, entry.vs)):
        if dst is not None:
            dst[:, one, :, :n].copy_(src)


@dataclasses.dataclass
class _PrefixEntry:
    tokens: tuple           # the prefix token ids (true length len(tokens))
    k: torch.Tensor         # (L, 1, KV, Pb, Dp), Pb = padded store length
    v: torch.Tensor
    ks: object = None       # (L, 1, KV, Pb) scales when the cache is int8
    vs: object = None


def _logprobs_of(logits: torch.Tensor, token: int, k: int):
    """One logprob record's arrays for a (V,) logits row (the prefill's
    first token): (chosen logprob, top-k ids, top-k logprobs) on the host."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(logp, k)
    return float(logp[token]), ids.cpu().numpy(), vals.cpu().numpy()


def _lp_rec(chosen, ids, vals, n: int) -> dict:
    """Host-side logprob record: chosen-token logprob + the top-n
    alternatives as (token_id, logprob) pairs."""
    return {"logprob": float(chosen),
            "top": [(int(i), float(v)) for i, v in zip(ids[:n], vals[:n])]}


def _i64(x: int) -> int:
    """A Python int's low 64 bits as a signed int64 value."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def _derive(seed: int, *words: int) -> int:
    """A seed derived from the engine's seed and words, as an int64."""
    state = np.random.SeedSequence([seed & ((1 << 64) - 1), *words])
    return _i64(int(state.generate_state(1, np.uint64)[0]))


class InferenceEngine:
    """Slot-based continuous batching over a fixed-shape KV cache.

    Usage:
        eng = InferenceEngine(model, max_batch=8, max_len=2048)
        uid = eng.submit([1, 2, 3], max_new_tokens=64)
        results = eng.run()          # drain everything
        results[uid]                 # -> list of generated token ids
    or incrementally: eng.step() until eng.pending() == 0.
    """

    def __init__(self, model: Llama, max_batch: int = 8, max_len: int = 2048,
                 sampler: SamplerConfig = SamplerConfig(), impl: str = "auto",
                 decode_chunk: int = 16, max_decode_chunk: int = 0,
                 prefill_buckets: Optional[List[int]] = None, seed: int = 0,
                 stream_cb: Optional[Callable[[int, List[int], bool], None]] = None,
                 step_fns=None, cache: Optional[KVCache] = None,
                 prefill_chunk: int = 256, prefill_budget: int = 1,
                 speculative: bool = False, spec_k: int = 8,
                 spec_ngram: int = 3, prefix_cache_size: int = 0,
                 prefix_cache_max_len: int = 256,
                 prefix_cache_min_reuse: int = 16, kv_quant: bool = False,
                 logprobs_k: int = 8):
        """model: the Llama to serve; the engine runs on its device.  impl
        as runtime/generate.py checks it.
        step_fns: optional (prefill_fn, decode_fn) pair replacing the
        single-device steps, e.g. a mesh's (with a sharded cache):
          prefill_fn(model, tokens (1, Tb), true_len, cache, slot,
                     start_pos) -> (last logits (V,), cache)
          decode_fn(model, last (B,), cache, steps, streams
                    (CounterStreams), active (B,), eos_ids (B,),
                    remaining (B,), state SamplerState|None,
                    counts (B, V) int32|None)
              -> (tokens (B, steps), cache) or, when counts is given,
                 (tokens, cache, counts)
        (prefill_slot and decode_chunk of this module are such a pair).
        With step_fns the prefix cache is off, and logprobs and seeds are
        refused, as in the JAX package.
        prefill_chunk: long prompts prefill in chunks of at most this many
        tokens.  stream_cb(uid, tokens_so_far, done): after every decode
        chunk that produced tokens for the request, and once more with
        done=True on completion.
        speculative: the single-stream latency mode (max_batch 1, no
        step_fns): a greedy request with no penalties and no logprobs
        decodes its chunks through lookup speculation
        (runtime/speculative.py; spec_k drafts from spec_ngram-grams a
        round), several tokens a forward on self-repetitive text; any
        other request keeps the normal chunked path.
        prefix_cache_size: keep the KV rows of the last N distinct prompt
        prefixes (LRU) and skip prefilling the longest common prefix a
        new prompt shares with one (0 disables; single-device engines
        only).  prefix_cache_max_len bounds the positions stored per
        entry; prefix_cache_min_reuse is the shortest match worth a copy.
        kv_quant: an int8 KV cache (half the KV bytes a step reads).
        logprobs_k: the static top-k width of logprob records (submit's
        logprobs is capped at it).  max_decode_chunk: the chunk doubles up
        to it while nothing competes (no queue, no prefill, no stop
        sequences), bounded by the smallest remaining budget; 0 keeps
        decode_chunk."""
        if speculative and (max_batch != 1 or step_fns is not None):
            raise ValueError("the speculative engine mode is single-stream and "
                             "single-device: max_batch=1 and no step_fns")
        _check_impl(model, impl)
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.impl = impl
        self._step_fns = step_fns
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        self._pf_rr = 0
        self.B = max_batch
        self.S = max_len
        self.sampler = sampler
        self.chunk = decode_chunk
        self.max_chunk = max(max_decode_chunk, decode_chunk) \
            if max_decode_chunk else decode_chunk
        self.stream_cb = stream_cb
        self.speculative = speculative
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self._spec_run = None   # the lookup run's buffers and graph, at first use
        if prefill_buckets is None:
            prefill_buckets = []
            b = 16
            while b < min(max_len, prefill_chunk):
                prefill_buckets.append(b)
                b *= 4
            prefill_buckets.append(min(max_len, prefill_chunk))
        self.buckets = sorted(set(prefill_buckets))
        self.cache = cache if cache is not None else KVCache.create(
            self.cfg, max_batch, max_len, device=self.device, quant=kv_quant)
        # draws: counter-based streams, so nothing holds generator state.
        # A seeded request's row is (its seed, its token index); while none
        # is live every row is (a per-row seed from the engine's, the
        # engine's decode step counter), which a warm-up does not move
        self.seed = seed
        self._decode_step_no = 0
        self._row_seeds = np.array([_derive(seed, 1, b) for b in range(max_batch)],
                                   np.int64)
        self._n_admitted = 0   # numbers unseeded slots' chains
        self._n_firsts = 0     # numbers unseeded first-token draws
        self._uid = itertools.count()
        self.waiting: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.last_tokens = np.zeros((max_batch,), np.int64)
        # per-slot sampling params: used while any LIVE request overrides
        # the engine default (counted, so an all-greedy batch returns to
        # the static-sampler graph once override requests drain)
        self._n_dynamic = 0
        self.logprobs_k = max(int(logprobs_k), 1)
        self._n_logprobs = 0
        self._n_seeded = 0
        self._slot_seed = np.zeros((max_batch,), np.int64)
        self._slot_temp = np.full((max_batch,), sampler.temperature, np.float32)
        self._slot_topk = np.full((max_batch,), sampler.top_k, np.int64)
        self._slot_topp = np.full((max_batch,), sampler.top_p, np.float32)
        self._slot_minp = np.full((max_batch,), sampler.min_p, np.float32)
        self._slot_rp = np.full((max_batch,), sampler.repeat_penalty, np.float32)
        self._slot_pp = np.full((max_batch,), sampler.presence_penalty, np.float32)
        self._slot_fp = np.full((max_batch,), sampler.frequency_penalty, np.float32)
        self._buf = _ChunkBuffers(max_batch, self.cfg.vocab_size, self.max_chunk,
                                  self.logprobs_k, self.device)
        # the penalties' counts while a penalized request is live (else
        # None, and zeroed when they come back, as JAX allocates anew)
        self._counts = None
        # CUDA graphs of the decode step by variant (dynamic, penalized,
        # logprobs), all in one memory pool
        self._graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self._pool = None
        self._events = None   # CUDA events around the last chunk's replays
        self.finished: Dict[int, Request] = {}
        self.prefix_cache_size = prefix_cache_size if step_fns is None else 0
        self.prefix_cache_max_len = prefix_cache_max_len
        self.prefix_cache_min_reuse = max(prefix_cache_min_reuse, 1)
        self._prefixes: "OrderedDict[tuple, _PrefixEntry]" = OrderedDict()
        # counters (observability; served by runtime/server.py /v1/stats):
        # the JAX package's, and the graphs' (captures, their setup
        # seconds, replays, eager steps, the replays' device ms from CUDA
        # events) and the prefill chunks by bucket
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "chunks": 0, "prefills": 0,
                      "decode_s": 0.0, "prefill_s": 0.0,
                      "requests_finished": 0,
                      "prefix_hits": 0, "prefix_tokens_reused": 0,
                      "graph_captures": 0, "capture_s": 0.0,
                      "graph_replays": 0, "eager_steps": 0, "replay_ms": 0.0,
                      "prefill_chunks": {}}

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new_tokens: int = 128,
               eos_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               min_p: Optional[float] = None,
               repeat_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               stop_tokens: Optional[List[List[int]]] = None,
               logprobs: int = 0, seed: Optional[int] = None) -> int:
        """Queue a request; returns its uid.  Raises ValueError for an
        empty prompt, token ids outside the vocabulary, a prompt plus
        budget past max_len, an empty stop sequence, or logprobs or a seed
        on step_fns."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if min(prompt) < 0 or max(prompt) >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids out of range [0, {self.cfg.vocab_size})")
        if len(prompt) + max_new_tokens > self.S:
            raise ValueError(f"prompt {len(prompt)} + max_new {max_new_tokens} "
                             f"exceeds engine max_len {self.S}")
        if logprobs:
            if self._step_fns is not None:
                raise ValueError("logprobs are single-device only (step_fns)")
            logprobs = min(int(logprobs), self.logprobs_k)
        if seed is not None and self._step_fns is not None:
            raise ValueError("per-request seeds are single-device only (step_fns)")
        if stop_tokens:
            stop_tokens = [[int(t) for t in s] for s in stop_tokens]
            if not all(stop_tokens):
                raise ValueError("empty stop sequence")
        uid = next(self._uid)
        ov = (temperature, top_k, top_p, min_p, repeat_penalty,
              presence_penalty, frequency_penalty)
        if any(v is not None for v in ov):
            self._n_dynamic += 1
        if logprobs:
            self._n_logprobs += 1
        if seed is not None:
            self._n_seeded += 1
        self.waiting.append(Request(uid, prompt, max_new_tokens, eos_id,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p, min_p=min_p,
                                    repeat_penalty=repeat_penalty,
                                    presence_penalty=presence_penalty,
                                    frequency_penalty=frequency_penalty,
                                    stop_tokens=stop_tokens,
                                    logprobs=logprobs, seed=seed))
        return uid

    def pending(self) -> int:
        return len(self.waiting) + sum(r is not None for r in self.slots)

    def _on_device(self):
        """The model's card as the current device (a serving thread's own
        current device may be another), or nothing on the CPU."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()

    @torch.no_grad()
    def warmup(self):
        """Run every prefill bucket and capture the decode step's base
        graph (static sampler, no penalties, no logprobs), so that the
        first requests pay neither; with the prefix cache, copy a block
        out and back at every store size.  Warm outputs are discarded:
        every slot is frozen in the decode step, pos is reset to 0 (which
        masks every scratch write), and the decode step counter and the
        seeds' counters do not move, so a warmed engine produces a cold
        one's tokens; of the stats only the graphs' counters (captures,
        their seconds, eager steps) count the warm-up."""
        if self._step_fns is not None:
            return
        saved = dict(self.stats, prefill_chunks=dict(self.stats["prefill_chunks"]))
        with self._on_device():
            for b in self.buckets:
                toks = torch.zeros((1, b), dtype=torch.long, device=self.device)
                prefill_slot(self.model, toks, 1, self.cache, 0, 0)
            zeros = np.zeros((self.B,), np.int64)
            self._fill(zeros, zeros, zeros, zeros, 0)
            self._run_steps((False, False, 0), 1)
            if self.prefix_cache_size:
                ml = self.cache.max_len
                cap = min(self.prefix_cache_max_len, ml)
                for pb in sorted({min(round_up(n, 128), ml)
                                  for n in range(128, cap + 1, 128)} | {min(128, ml)}):
                    k, v, ks, vs = _extract_prefix(self.cache, 0, pb)
                    _insert_prefix(self.cache, 0, _PrefixEntry((), k, v, ks, vs))
            self.cache.pos.zero_()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.stats = dict(saved, **{k: self.stats[k] for k in (
            "graph_captures", "capture_s", "eager_steps")})

    def run(self) -> Dict[int, List[int]]:
        """Drain all submitted requests; returns {uid: generated tokens}."""
        while self.pending():
            self.step()
        return {uid: r.output for uid, r in self.finished.items()}

    # ------------------------------------------------------------ internals
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.buckets[-1]}")

    def _admit(self):
        """Assign waiting requests to free slots (prefill advances a chunk
        at a time in step(), interleaved with decode)."""
        for slot in range(self.B):
            if not self.waiting:
                return
            if self.slots[slot] is not None:
                continue
            req = self.waiting.popleft()
            req.prefill_t0 = time.perf_counter()
            self.slots[slot] = req
            s = self.sampler

            def pick(v, default):
                return default if v is None else v
            self._slot_temp[slot] = pick(req.temperature, s.temperature)
            self._slot_topk[slot] = pick(req.top_k, s.top_k)
            self._slot_topp[slot] = pick(req.top_p, s.top_p)
            self._slot_minp[slot] = pick(req.min_p, s.min_p)
            self._slot_rp[slot] = pick(req.repeat_penalty, s.repeat_penalty)
            self._slot_pp[slot] = pick(req.presence_penalty, s.presence_penalty)
            self._slot_fp[slot] = pick(req.frequency_penalty, s.frequency_penalty)
            # a seeded request's chain is a function of its seed; an
            # unseeded slot's of the engine's seed and the admission count
            # (used only while a seeded request is live)
            self._slot_seed[slot] = (_i64(req.seed) if req.seed is not None
                                     else _derive(self.seed, 2, self._n_admitted))
            self._n_admitted += 1
            if self._slot_penalized(slot) and self._counts is None:
                self._counts = self._buf.counts()
                self._counts.zero_()
            if self._counts is not None:  # fresh request: clear its row
                self._counts[slot] = 0
            if self.prefix_cache_size:
                self._apply_prefix(slot, req)

    def _slot_penalized(self, slot: int) -> bool:
        return (self._slot_rp[slot] != 1.0 or self._slot_pp[slot] != 0.0
                or self._slot_fp[slot] != 0.0)

    # --------------------------------------------------- prompt-prefix cache
    def _apply_prefix(self, slot: int, req: Request):
        """Longest-common-prefix lookup at admission: copy the best stored
        block into the slot and start prefill at the match point (at least
        one prompt token always remains: its logits seed the first draw).
        The slot's pos moves to the match point too, so that the frozen
        writes of decode steps run before its first prefill chunk land on
        the row that chunk writes first, not inside the copied prefix."""
        best_key, best_m = None, 0
        for key, entry in self._prefixes.items():
            m = 0
            for a, b in zip(entry.tokens, req.prompt):
                if a != b:
                    break
                m += 1
            m = min(m, req.prompt_len - 1)
            if m > best_m:
                best_key, best_m = key, m
        if best_key is None or best_m < self.prefix_cache_min_reuse:
            return
        self._prefixes.move_to_end(best_key)
        _insert_prefix(self.cache, slot, self._prefixes[best_key])
        self.cache.pos[slot] = best_m
        req.prefill_off = best_m
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens_reused"] += best_m

    def _store_prefix(self, slot: int, req: Request):
        """Snapshot the freshly prefilled prompt's KV (capped at
        prefix_cache_max_len positions) into the LRU."""
        n = min(req.prompt_len, self.prefix_cache_max_len, self.S)
        if n <= self.prefix_cache_min_reuse:
            return
        key = tuple(req.prompt[:n])
        if key in self._prefixes:
            self._prefixes.move_to_end(key)
            return
        pb = min(round_up(n, 128), self.cache.max_len)
        k, v, ks, vs = _extract_prefix(self.cache, slot, pb)
        self._prefixes[key] = _PrefixEntry(tokens=key, k=k, v=v, ks=ks, vs=vs)
        while len(self._prefixes) > self.prefix_cache_size:
            self._prefixes.popitem(last=False)

    def _prefill_one_chunk(self, slot: int, req: Request):
        """Advance one prefill chunk for the request in `slot`."""
        off = req.prefill_off
        n = min(self.prefill_chunk, req.prompt_len - off)
        bucket = self._bucket(n)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = req.prompt[off:off + n]
        toks = torch.from_numpy(toks).to(self.device)
        prefill = self._step_fns[0] if self._step_fns is not None else prefill_slot
        last, self.cache = prefill(self.model, toks, n, self.cache, slot, off)
        chunks = self.stats["prefill_chunks"]
        chunks[bucket] = chunks.get(bucket, 0) + 1
        req.prefill_off = off + n
        req.last_logits = last
        if req.prefilling:
            return
        # prompt fully ingested -> first token
        if self.prefix_cache_size:
            self._store_prefix(slot, req)
        # seeded mode: draw index 0 of the slot's chain (decode chunks go on
        # at index len(output)); else the engine's own first-token chain
        if self._n_seeded:
            seed = int(self._slot_seed[slot])
        else:
            seed = _derive(self.seed, 3, self._n_firsts)
            self._n_firsts += 1
        streams = CounterStreams(
            torch.tensor([seed], dtype=torch.int64, device=self.device),
            torch.zeros((1,), dtype=torch.int64, device=self.device))
        if self._dynamic_sampling:
            i = slice(slot, slot + 1)
            st = SamplerState.make(self._slot_temp[i], self._slot_topk[i].tolist(),
                                   self._slot_topp[i], self._slot_rp[i],
                                   self._slot_pp[i], self._slot_fp[i],
                                   self._slot_minp[i], device=self.device)
            first = int(sample_state(last[None], streams, st)[0])
        else:
            first = int(sample(last[None], streams, self.sampler)[0])
        if req.logprobs:
            req.logprobs_out.append(_lp_rec(
                *_logprobs_of(last, first, self.logprobs_k), req.logprobs))
        req.last_logits = None
        req.output.append(first)
        if self._counts is not None:
            self._counts[slot, first] += 1
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += req.prompt_len
        self.stats["prefill_s"] += time.perf_counter() - req.prefill_t0
        if self._finished_after_append(req):
            self._finish(slot=slot, req=req)
            return
        self.last_tokens[slot] = first
        if self.stream_cb:
            self.stream_cb(req.uid, list(req.output), False)

    def _finished_after_append(self, req: Request) -> bool:
        """Host-side finish check after each appended token.  Records WHY in
        req.finish_reason and, on a stop_tokens match, TRUNCATES the matched
        sequence off the output.  Idempotent."""
        if req.finish_reason:
            return True
        if req.eos_id is not None and req.output and req.output[-1] == req.eos_id:
            req.finish_reason = "eos"
            return True
        for s in req.stop_tokens or ():
            if len(req.output) >= len(s) and req.output[-len(s):] == s:
                del req.output[-len(s):]
                req.finish_reason = "stop"
                return True
        if len(req.output) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        if req.prompt_len + len(req.output) >= self.S:
            req.finish_reason = "length"
            return True
        return False

    @property
    def _dynamic_sampling(self) -> bool:
        return self._n_dynamic > 0

    @staticmethod
    def _req_has_overrides(req: Request) -> bool:
        return any(v is not None for v in (
            req.temperature, req.top_k, req.top_p, req.min_p,
            req.repeat_penalty, req.presence_penalty, req.frequency_penalty))

    def _drop_dynamic(self, req: Request):
        if self._req_has_overrides(req):
            self._n_dynamic -= 1
        if req.logprobs:
            self._n_logprobs -= 1
            req.logprobs = 0  # idempotent (cancel after finish, etc.)
        if req.seed is not None:
            self._n_seeded -= 1
            req.seed = None

    def _finish(self, slot: Optional[int], req: Request):
        req.done = True
        # a stop_tokens truncation shortens output after its logprob
        # records were appended: keep the two aligned
        if req.logprobs_out:
            del req.logprobs_out[len(req.output):]
        self._drop_dynamic(req)
        self.finished[req.uid] = req
        self.stats["requests_finished"] += 1
        if self.stream_cb:
            self.stream_cb(req.uid, req.output, True)
        if slot is not None:
            self._release_slot(slot)

    def _release_slot(self, slot: int):
        """Free a slot: neutralize its penalty params, and stop the counts
        once no occupied slot is penalized (the penalty-free graph comes
        back)."""
        self.slots[slot] = None
        if self._counts is not None:
            self._slot_rp[slot] = self.sampler.repeat_penalty
            self._slot_pp[slot] = self.sampler.presence_penalty
            self._slot_fp[slot] = self.sampler.frequency_penalty
            if not self.sampler.has_penalties and not any(
                    r is not None and self._slot_penalized(i)
                    for i, r in enumerate(self.slots)):
                self._counts = None

    def request(self, uid: int) -> Optional[Request]:
        """Look up a request by uid wherever it lives (waiting queue, a
        slot, or the finished map); None if unknown."""
        for r in self.waiting:
            if r.uid == uid:
                return r
        for r in self.slots:
            if r is not None and r.uid == uid:
                return r
        return self.finished.get(uid)

    def cancel(self, uid: int) -> bool:
        """Abort a request: drop it from the wait queue or free its slot.
        Already-finished requests are discarded from `finished`.  Returns
        True if the uid was found.  No stream_cb is invoked."""
        for i, r in enumerate(self.waiting):
            if r.uid == uid:
                del self.waiting[i]
                self._drop_dynamic(r)
                return True
        for slot, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._release_slot(slot)
                self._drop_dynamic(r)
                return True
        return self.finished.pop(uid, None) is not None

    def _pick_chunk(self, active_np, rem_np) -> int:
        """Decode-chunk size for this tick: doubles up to max_decode_chunk
        while nothing waits to be admitted, no slot is mid-prefill and no
        active request has stop sequences, bounded by the smallest active
        remaining budget."""
        c = self.chunk
        if self.max_chunk <= c or self.waiting:
            return c
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if r.prefilling or (active_np[i] and r.stop_tokens):
                return c
        lo = int(rem_np[active_np].min())
        while c * 2 <= self.max_chunk and c * 2 <= lo:
            c *= 2
        return c

    def _fill(self, active_np, eos_np, rem_np, seeds, index) -> None:
        """The chunk's per-slot inputs into the buffers, one copy each."""
        ints = np.stack([self.last_tokens, active_np.astype(np.int64),
                         eos_np, rem_np, seeds,
                         np.broadcast_to(np.asarray(index, np.int64), (self.B,)),
                         np.ones((self.B,), np.int64), self._slot_topk])
        floats = np.stack([self._slot_temp, self._slot_topp, self._slot_minp,
                           self._slot_rp, self._slot_pp, self._slot_fp])
        self._buf.fill(ints, floats)

    def _capture(self, key) -> torch.cuda.CUDAGraph:
        """The decode step of variant `key` as a CUDA graph in the engine's
        pool: one eager step on a side stream first (what capture needs:
        every lazily made buffer exists before it, and it is the chunk's
        real first step), then the capture."""
        t0 = time.perf_counter()
        step = functools.partial(self._step_once, key)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            step()
        self._graphs[key] = graph
        self.stats["graph_captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return graph

    def _step_once(self, key) -> None:
        dynamic, penalized, logprobs_k = key
        _decode_step(self.model, self.sampler, self._buf, self.cache, dynamic,
                     penalized, logprobs_k)

    def _run_steps(self, key, steps: int) -> None:
        """`steps` decode steps of variant key from the filled buffers: on
        the card replays of the variant's graph (captured here at first
        use, its warm-up being the first step), timed by CUDA events; on
        the CPU eager steps."""
        if self.device.type != "cuda":
            for _ in range(steps):
                self._step_once(key)
            self.stats["eager_steps"] += steps
            return
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(key)
            self.stats["eager_steps"] += 1
            steps -= 1
        if steps <= 0:
            return
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(steps):
            graph.replay()
        stop.record()
        self.stats["graph_replays"] += steps
        self._events = (start, stop)

    @torch.no_grad()
    def step(self):
        """One scheduling tick: admit waiting requests to slots, advance at
        most `prefill_budget` prefill chunks (round-robin), then decode a
        chunk for every slot in the decode phase."""
        with self._on_device():
            self._step()

    def _step(self):
        self._admit()
        budget = self.prefill_budget
        order = [(self._pf_rr + i) % self.B for i in range(self.B)]
        for slot in order:
            if budget == 0:
                break
            req = self.slots[slot]
            if req is not None and req.prefilling:
                self._prefill_one_chunk(slot, req)
                self._pf_rr = (slot + 1) % self.B
                budget -= 1
        active_np = np.array([
            r is not None and not r.prefilling and len(r.output) > 0
            for r in self.slots], dtype=bool)
        if not active_np.any():
            return
        # device-side finish conditions: per-slot eos ids (-1 = none) and
        # remaining token budgets; such a slot freezes mid-chunk
        eos_np = np.array([
            r.eos_id if (r is not None and r.eos_id is not None) else -1
            for r in self.slots], dtype=np.int64)
        rem_np = np.array([
            max(r.max_new_tokens - len(r.output), 0)
            if (r is not None and active_np[i]) else 0
            for i, r in enumerate(self.slots)], dtype=np.int64)
        if (self.speculative and self._slot_temp[0] <= 0.0
                and self._counts is None and self._n_logprobs == 0
                and self._spec_fits()):
            return self._decode_chunk_speculative()
        t0 = time.perf_counter()
        chunk = self._pick_chunk(active_np, rem_np)
        if self._n_seeded:
            seeds = self._slot_seed
            index = np.array([len(r.output) if r is not None else 0
                              for r in self.slots], np.int64)
        else:
            seeds, index = self._row_seeds, self._decode_step_no
        self._decode_step_no += chunk
        lpk = self.logprobs_k if self._n_logprobs else 0
        lps = None
        if self._step_fns is not None:
            toks = self._decode_with_step_fns(chunk, active_np, eos_np, rem_np,
                                              seeds, index)
        else:
            self._fill(active_np, eos_np, rem_np, seeds, index)
            self._events = None
            self._run_steps((self._dynamic_sampling, self._counts is not None,
                             lpk), chunk)
            buf = self._buf
            toks = buf.out[:, :chunk].cpu().numpy()  # the one host sync a chunk
            if lpk:
                lps = (buf.lp[:, :chunk].cpu().numpy(),
                       buf.lp_ids[:, :chunk].cpu().numpy(),
                       buf.lp_vals[:, :chunk].cpu().numpy())
            if self._events is not None:
                self.stats["replay_ms"] += self._events[0].elapsed_time(self._events[1])
        self.stats["chunks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot, req in enumerate(self.slots):
            if req is None or not active_np[slot]:
                continue  # empty, still prefilling, or no first token yet
            for j, t in enumerate(toks[slot]):
                req.output.append(int(t))
                if lps is not None and req.logprobs:
                    req.logprobs_out.append(
                        _lp_rec(lps[0][slot, j], lps[1][slot, j],
                                lps[2][slot, j], req.logprobs))
                self.stats["decode_tokens"] += 1
                if self._finished_after_append(req):
                    break
            if req.output:  # stop truncation can empty a 1-token output
                self.last_tokens[slot] = req.output[-1]
            if req.done or self._finished_after_append(req):
                self._finish(slot, req)
            elif self.stream_cb:
                self.stream_cb(req.uid, list(req.output), False)

    def _spec_fits(self) -> bool:
        req = self.slots[0]
        hist_len = req.prompt_len + len(req.output)
        return hist_len + self.chunk + self.spec_k + 1 <= self.S

    def _decode_chunk_speculative(self):
        """The one slot's greedy chunk through lookup speculation
        (decode_chunk_speculative's rounds with steps = chunk + 1, the
        request's last token being the seed).  On entry cache.pos ==
        history length - 1 (the last token's K/V is written by the next
        forward), the engine's decode-phase state.  The run's buffers and
        its CUDA graph are made at the first such chunk and kept."""
        req = self.slots[0]
        hist_len = req.prompt_len + len(req.output)
        hist = np.zeros((1, self.S), np.int64)
        hist[0, :hist_len] = req.prompt + req.output
        t0 = time.perf_counter()
        if self._spec_run is None:
            self._spec_run = _LookupRun(self.model, self.cache, self.chunk + 1,
                                        self.spec_ngram, self.spec_k,
                                        SamplerConfig(), None, self.S)
        st = {}
        toks, emitted, nf, _ = self._spec_run.run(
            torch.from_numpy(hist).to(self.device), hist_len, stats=st)
        new = toks[0, 1:emitted].tolist()
        self.stats["chunks"] += 1
        self.stats["spec_forwards"] = self.stats.get("spec_forwards", 0) + nf
        self.stats["graph_captures"] += int(st["captured"])
        self.stats["graph_replays"] += st["replays"]
        self.stats["decode_s"] += time.perf_counter() - t0
        for t in new:
            req.output.append(int(t))
            self.stats["decode_tokens"] += 1
            if self._finished_after_append(req):
                break
        if req.output:  # stop truncation can empty a 1-token output
            self.last_tokens[0] = req.output[-1]
        if self._finished_after_append(req):
            self._finish(0, req)
        elif self.stream_cb:
            self.stream_cb(req.uid, list(req.output), False)

    def _decode_with_step_fns(self, chunk, active_np, eos_np, rem_np, seeds,
                              index) -> np.ndarray:
        """A chunk through step_fns' decode function -> tokens (B, chunk)."""
        dev = self.device

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(dev)
        state = None
        if self._dynamic_sampling:
            state = SamplerState.make(self._slot_temp, self._slot_topk.tolist(),
                                      self._slot_topp, self._slot_rp,
                                      self._slot_pp, self._slot_fp,
                                      self._slot_minp, device=dev)
        streams = CounterStreams(
            t(seeds), t(np.broadcast_to(np.asarray(index, np.int64), (self.B,))))
        r = self._step_fns[1](self.model, t(self.last_tokens), self.cache,
                              chunk, streams, t(active_np), t(eos_np), t(rem_np),
                              state, self._counts)
        if self._counts is not None:
            toks, self.cache, counts = r
            if counts is not self._counts:
                self._counts.copy_(counts)
        else:
            toks, self.cache = r
        return toks.cpu().numpy()
