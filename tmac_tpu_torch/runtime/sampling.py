"""Token samplers: greedy, temperature, top-k, top-p, min-p and the
repetition penalties (the port of ``tmac_tpu/runtime/sampling.py``).

The JAX package runs these as XLA ops inside its jitted decode step; here
they are torch ops, and on the card they run inside the decode loop's
CUDA graph (runtime/generate.py), so nothing in them may wait for the
host: no ``.item()``, no boolean-mask indexing, no ``torch.multinomial``.
Draws come from ``torch.Generator``s that the caller passes: one for the
whole batch, or a sequence of one per row (the counterpart of JAX's (B, 2)
keys), or from ``CounterStreams``, whose draws are a pure function of a
(seed, index) pair per row (the counterpart of JAX's
``fold_in(key, index)``, which the engine's per-request seeds use).
Nothing draws from the global generator.  Threefry, Philox and the
counter hash give different numbers from one seed, so the draws are
compared with JAX's by their distribution, not their values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

_M32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds; multipliers below
    2^31, so that each product of int64 values in [0, 2^32) is exact) of
    h, an int64 tensor in [0, 2^32), elementwise."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


@dataclasses.dataclass
class CounterStreams:
    """Per-row draws that are a pure function of (seed[b], index[b]): row
    b's Exp(1) noise over the vocabulary hashes the pair with each token
    id, in tensor ops, so a draw needs no generator state, and a CUDA graph
    of a step that reads seed and index from its buffers draws anew at
    every replay once index moves.  The counterpart of the JAX package's
    per-slot ``fold_in(PRNGKey(seed), index)``: a seeded request's noise
    at token i depends on nothing else."""

    seed: torch.Tensor   # (B,) int64, all 64 bits used
    index: torch.Tensor  # (B,) int64, its low 32 bits used

    def exponentials(self, vocab: int) -> torch.Tensor:
        """(B, vocab) f32 Exp(1) draws, -log of a uniform on (0, 1) from the
        hash's top 24 bits."""
        seed, index = self.seed.long(), self.index.long()
        row = _mix32(_mix32((seed & _M32) ^ 0x9E3779B9) ^ ((seed >> 32) & _M32))
        row = _mix32(row ^ (index & _M32))
        col = _mix32(torch.arange(vocab, device=seed.device) ^ 0x85EBCA6B)
        h = _mix32(row[:, None] ^ col[None, :])
        u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
        return -torch.log(u)


Generators = Union[torch.Generator, Sequence[torch.Generator], CounterStreams]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled
    min_p: float = 0.0         # 0 => disabled (llama.cpp default 0.05)
    # repetition penalties over the GENERATED tokens of the request
    # (OpenAI-style scope).  repeat_penalty: llama.cpp classic (logit/p if
    # >0 else *p for seen tokens; 1 = off).  presence/frequency: OpenAI
    # additive forms.
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @property
    def has_penalties(self) -> bool:
        return (self.repeat_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


@dataclasses.dataclass
class SamplerState:
    """Per-row sampling parameters as (B,) tensors, so that rows with
    different settings share one decode step (and one CUDA graph)."""

    temperature: torch.Tensor  # (B,) f32; <= 0 => greedy for that row
    top_k: torch.Tensor        # (B,) int32; 0 => disabled
    top_p: torch.Tensor        # (B,) f32; 1.0 => disabled
    min_p: torch.Tensor        # (B,) f32; 0.0 => disabled
    repeat_penalty: torch.Tensor     # (B,) f32; 1.0 => off
    presence_penalty: torch.Tensor   # (B,) f32; 0.0 => off
    frequency_penalty: torch.Tensor  # (B,) f32; 0.0 => off

    @classmethod
    def make(cls, temperature, top_k, top_p, repeat_penalty=None,
             presence_penalty=None, frequency_penalty=None, min_p=None,
             device="cuda") -> "SamplerState":
        n = len(temperature)

        def f32(v, default):
            return torch.tensor(v if v is not None else [default] * n,
                                dtype=torch.float32, device=device)
        return cls(
            temperature=f32(temperature, 0.0),
            top_k=torch.tensor(top_k, dtype=torch.int32, device=device),
            top_p=f32(top_p, 1.0),
            min_p=f32(min_p, 0.0),
            repeat_penalty=f32(repeat_penalty, 1.0),
            presence_penalty=f32(presence_penalty, 0.0),
            frequency_penalty=f32(frequency_penalty, 0.0),
        )

    @classmethod
    def broadcast(cls, cfg: SamplerConfig, batch: int,
                  device="cuda") -> "SamplerState":
        return cls.make([cfg.temperature] * batch, [cfg.top_k] * batch,
                        [cfg.top_p] * batch,
                        [cfg.repeat_penalty] * batch,
                        [cfg.presence_penalty] * batch,
                        [cfg.frequency_penalty] * batch,
                        [cfg.min_p] * batch, device=device)


def _column(p, rows: int, ref: torch.Tensor):
    """A penalty parameter, a Python number or a (B,) tensor, in a form
    that broadcasts against (B, V): numbers stay scalars (no host-to-device
    copy, which a CUDA graph could not hold)."""
    if isinstance(p, torch.Tensor):
        return p.to(device=ref.device, dtype=torch.float32).expand(rows)[:, None]
    return float(p)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    repeat_penalty, presence_penalty,
                    frequency_penalty) -> torch.Tensor:
    """Repetition penalties over per-request token counts.

    logits (B, V); counts (B, V) int32 occurrences in the request's
    GENERATED tokens; each penalty a Python number or a (B,) tensor.
    repeat_penalty follows llama.cpp (divide positive logits, multiply
    negative ones, for seen tokens); presence/frequency are the OpenAI
    additive forms.  Neutral params (1, 0, 0) return the logits unchanged
    in f32."""
    lf = logits.float()
    B = lf.shape[0]
    rp = _column(repeat_penalty, B, lf)
    pp = _column(presence_penalty, B, lf)
    fp = _column(frequency_penalty, B, lf)
    seen = counts > 0
    pen = torch.where(lf > 0, lf / rp, lf * rp)
    lf = torch.where(seen, pen, lf)
    return lf - pp * seen.float() - fp * counts.float()


def bump_counts(counts: torch.Tensor, tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """counts (B, V) += one_hot(tokens (B,)), only for active rows.  Unlike
    the JAX package's functional update, the counts are updated IN PLACE
    (the decode loop's graph keeps them in one buffer) and returned."""
    B = counts.shape[0]
    inc = (torch.ones((B, 1), dtype=counts.dtype, device=counts.device)
           if active is None else active.to(counts.dtype)[:, None])
    return counts.scatter_add_(1, tokens.long()[:, None], inc)


def filtered_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """The temperature/top-k/top-p/min-p-masked logits `sample` draws from,
    (..., V) -> (..., V) f32 with the filtered entries at -inf."""
    assert cfg.temperature > 0.0
    base = logits.float()  # pre-temperature, for min_p
    logits = base / cfg.temperature
    if cfg.top_k > 0:
        # ties at the k-th value are kept
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens until the cumulative probability exceeds top_p (the
        # top-1 always; the clamp guards the float edge cum[-1] < top_p)
        cutoff_idx = (cum < cfg.top_p).sum(-1, keepdim=True) \
            .clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    if cfg.min_p > 0.0:
        # llama.cpp min-p: drop tokens whose probability is below
        # min_p * max_prob, on the PRE-temperature distribution over the
        # surviving support
        probs = torch.softmax(
            torch.where(torch.isfinite(logits), base, float("-inf")), dim=-1)
        pmax = probs.amax(-1, keepdim=True)
        logits = torch.where(probs < cfg.min_p * pmax, float("-inf"), logits)
    return logits


def _categorical(generator: Generators, logits: torch.Tensor) -> torch.Tensor:
    """A draw from softmax(logits) for every row of (B, V), by the
    exponential race: argmax(logits - log E) with E ~ Exp(1) i.i.d. (the
    Gumbel-max trick), which needs no host round trip.  generator: one
    torch.Generator for the whole batch, or a sequence of one per row (a
    row's draws then depend only on its own generator, not on the batch's
    other rows), or CounterStreams (a row's draws a function of its
    (seed, index))."""
    if isinstance(generator, CounterStreams):
        e = generator.exponentials(logits.shape[-1])
    elif isinstance(generator, torch.Generator):
        e = torch.empty_like(logits, dtype=torch.float32).exponential_(
            generator=generator)
    else:
        if len(generator) != logits.shape[0]:
            raise ValueError(f"{len(generator)} generators for "
                             f"{logits.shape[0]} rows")
        e = torch.stack([torch.empty(logits.shape[-1], device=logits.device)
                         .exponential_(generator=g) for g in generator])
    # a zero draw would give +inf against a masked -inf: keep E > 0
    e = e.clamp_min_(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - e.log(), dim=-1)


def _need_generator(generator: Optional[Generators]) -> Generators:
    if generator is None:
        raise ValueError("sampling needs a torch.Generator (or one per "
                         "row); nothing draws from the global one")
    return generator


def sample(logits: torch.Tensor, generator: Optional[Generators] = None,
           cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32.  Greedy (temperature <= 0):
    the first index of the maximum, as jnp.argmax; otherwise a draw from
    filtered_logits with `generator`.  The penalties are the decode loop's
    (apply_penalties), as in the JAX package."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return _categorical(_need_generator(generator),
                        filtered_logits(logits, cfg)).to(torch.int32)


def sample_state(logits: torch.Tensor, generator: Generators,
                 st: SamplerState) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32 with PER-ROW params.

    sample()'s semantics row by row: temperature <= 0 is greedy; top-k
    masks below the k-th largest; top-p masks below the nucleus cutoff of
    the top-k-filtered distribution; min-p on the pre-temperature
    probabilities over the surviving support.  One descending sort serves
    both top-k and top-p."""
    V = logits.shape[-1]
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    scaled = lf / torch.clamp_min(st.temperature, 1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: value must be >= the k-th largest (k <= 0 -> keep all)
    k_eff = torch.where(st.top_k > 0, st.top_k, V).clamp(1, V).long()
    kth = torch.gather(sorted_desc, -1, (k_eff - 1)[:, None])
    masked = torch.where(scaled < kth, float("-inf"), scaled)
    # top-p on the top-k-filtered distribution: in sorted space the top-k
    # mask is positional (the first k_eff entries), so no second sort
    pos = torch.arange(V, device=lf.device)[None, :]
    sorted_masked = torch.where(pos < k_eff[:, None], sorted_desc,
                                float("-inf"))
    cum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    cutoff_idx = (cum < st.top_p[:, None]).sum(-1, keepdim=True) \
        .clamp_max(V - 1)
    cutoff = torch.gather(sorted_masked, -1, cutoff_idx)
    masked = torch.where(scaled < cutoff, float("-inf"), masked)
    # min-p over the pre-temperature probabilities on the filtered support
    # (0 disables it for a row)
    probs_m = torch.softmax(
        torch.where(torch.isfinite(masked), lf, float("-inf")), dim=-1)
    pmax = probs_m.amax(-1, keepdim=True)
    masked = torch.where(probs_m < st.min_p[:, None] * pmax, float("-inf"),
                         masked)
    sampled = _categorical(_need_generator(generator), masked).to(torch.int32)
    return torch.where(st.temperature <= 0.0, greedy, sampled)
