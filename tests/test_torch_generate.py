"""The port's runtime (tmac_tpu_torch/runtime/generate.py and
perplexity.py) against the JAX package's: generate at the cache's rows,
teacher-forced against JAX on the same 128-row cache; the penalties in the
decode loop; seeds; impl; and the windowed perplexity and continuation
scores.  On the CPU decode_loop runs its step eagerly; a model on the card
replays it from a CUDA graph, whose bookkeeping runs here with a stand-in
for the capture (chip_smoke.py holds the real graph to the eager loop).

Gates: the model gates of tests/test_torch_model.py for logits (NMSE 1e-4
and tie-aware argmax agreement 1.0 on the decode steps after a short
prompt), and for the scores (a mean NLL, a log-likelihood) a relative
gate measured here, whose gap is XLA's CPU rsqrt (the recorded deviation,
ROADMAP Queue 3): given XLA's rsqrt values the port's scores come within
f32 summation order of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import _given_xla_rsqrt
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.runtime import perplexity as jppl
from tmac_tpu.runtime import sampling as js
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.runtime.generate import decode_loop, generate, prefill
from tmac_tpu_torch.runtime.perplexity import perplexity, score_continuations
from tmac_tpu_torch.runtime.sampling import SamplerConfig, sample
from tmac_tpu_torch.utils import argmax_agreement, nmse

torch.set_num_threads(2)

LOGITS_NMSE, TIE_MARGIN = 1e-4, 1e-2
# Relative gap of a mean NLL or a log-likelihood, measured on the CPU:
# perplexity up to 1.5e-4 (llama-2-7b, the 72-token window; bitnet-3b
# 4.9e-5, where windows of 16 random tokens already reach a row whose norm
# factor XLA's rsqrt rounds otherwise: logits NMSE up to 7e-4 from that
# position on), score_continuations up to 7.5e-8.  Given XLA's rsqrt
# values: at most 8.0e-8 (the f32 order of log_softmax and the sums).  The
# gate leaves room for another CPU's rsqrt estimate.
SCORE_REL, GIVEN_RSQRT_REL = 1e-3, 1e-6

_fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))


@pytest.fixture(scope="module")
def bitnet():
    cfg, jcfg = get_preset("bitnet-3b").scaled(8), jax_preset("bitnet-3b").scaled(8)
    return dict(cfg=cfg, jcfg=jcfg, model=Llama(cfg, init_params(cfg, 0, "cpu")),
                jparams=jl.init_params(jcfg, seed=0))


@pytest.fixture(scope="module")
def llama():
    cfg = get_preset("llama-2-7b").scaled(8)
    jcfg = jax_preset("llama-2-7b").scaled(8)
    params = init_params(cfg, 0, "cpu")
    return dict(cfg=cfg, jcfg=jcfg, model=Llama(cfg, params),
                plain=Llama(cfg, params, plain=True),
                jparams=jl.init_params(jcfg, seed=0))


def _jax_teacher_forced(run, prompt, toks, max_len, penalties=None):
    """JAX forward(impl="pallas") on a cache of max_len rows: the prompt's
    last logits, then one decode step per token of toks[:-1] (the port's
    tokens fed back): (len(toks), V) logits, the penalties applied to the
    decode steps' logits over the counts of toks as the port drew them."""
    jcfg, jparams = run["jcfg"], run["jparams"]
    cache = jl.KVCache.create(jcfg, 1, max_len)
    lg, cache = _fwd(jparams, jcfg, jnp.asarray(prompt), cache, impl="pallas")
    rows = [np.asarray(lg[0, -1])]
    counts = jnp.zeros((1, jcfg.vocab_size), jnp.int32)
    for t in toks[:-1]:
        counts = js.bump_counts(counts, jnp.asarray([t], jnp.int32))
        lg, cache = _fwd(jparams, jcfg, jnp.asarray([[t]]), cache, impl="pallas")
        row = lg[:, -1]
        if penalties is not None:
            row = js.apply_penalties(row, counts, *penalties)
        rows.append(np.asarray(row[0]))
    return np.stack(rows)


def _chosen(toks, V):
    out = np.zeros((len(toks), V), np.float32)
    out[np.arange(len(toks)), toks] = 1.0
    return out


def test_generate_at_the_cache_rows_matches_jax(bitnet):
    """A 40-token prompt and 60 new tokens at max_len=64: the cache has 128
    rows (64, rounded up to 128 by KVCache.create, as in the reference),
    which hold all 99 positions; then 89 new tokens, which need exactly
    the 128 rows (the last token is drawn, never written).  Teacher-forced
    against JAX on its own 128-row cache."""
    cfg = bitnet["cfg"]
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 40))
    out = generate(bitnet["model"], prompt, 60, max_len=64)
    assert out.shape == (1, 60) and out.dtype == torch.int32
    full = generate(bitnet["model"], prompt, 89, max_len=64)[0].tolist()
    assert full[:60] == out[0].tolist()
    ref = _jax_teacher_forced(bitnet, prompt, full, 128)
    assert np.isfinite(ref).all()
    assert argmax_agreement(ref, _chosen(full, cfg.vocab_size),
                            TIE_MARGIN) == 1.0


def test_generate_past_the_cache_rows_raises(bitnet):
    prompt = np.zeros((1, 40), np.int64)
    with pytest.raises(ValueError, match="cache rows"):
        generate(bitnet["model"], prompt, 90, max_len=64)


def test_decode_loop_logits_match_jax_steps(bitnet):
    """The loop's tokens are the argmax of JAX's teacher-forced logits, and
    the port's own step logits equal JAX's within LOGITS_NMSE."""
    cfg, model = bitnet["cfg"], bitnet["model"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8))
    cache = KVCache.create(cfg, 1, 32, device="cpu")
    logits, cache = prefill(model, torch.from_numpy(prompt), cache)
    first = sample(logits)
    toks, cache = decode_loop(model, first, cache, 8)
    seq = [int(first[0])] + toks[0].tolist()
    assert int(cache.pos[0]) == 8 + 8
    ref = _jax_teacher_forced(bitnet, prompt, seq, 32)
    # the port's logits on the same tokens, step by step
    cache = KVCache.create(cfg, 1, 32, device="cpu")
    lg, cache = model(torch.from_numpy(prompt), cache)
    mine = [lg[0, -1].numpy()]
    for t in seq[:-1]:
        lg, cache = model(torch.tensor([[t]]), cache)
        mine.append(lg[0, -1].numpy())
    for step, (r, m) in enumerate(zip(ref, mine)):
        assert nmse(r, m) <= LOGITS_NMSE, step
    assert argmax_agreement(ref, _chosen(seq, cfg.vocab_size), TIE_MARGIN) == 1.0


def test_penalized_greedy_loop_matches_jax(bitnet):
    """The reference's scan body: the step's logits penalized over the
    counts of the tokens drawn so far (the first one included), then the
    draw, then the counts bumped.  Greedy with all three penalties,
    teacher-forced against JAX's apply_penalties on JAX's logits."""
    cfg = bitnet["cfg"]
    sampler = SamplerConfig(repeat_penalty=1.3, presence_penalty=0.5,
                            frequency_penalty=0.5)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8))
    out = generate(bitnet["model"], prompt, 16, sampler=sampler)[0].tolist()
    assert out != generate(bitnet["model"], prompt, 16)[0].tolist()
    ref = _jax_teacher_forced(bitnet, prompt, out, 64, penalties=(
        sampler.repeat_penalty, sampler.presence_penalty,
        sampler.frequency_penalty))
    assert argmax_agreement(ref, _chosen(out, cfg.vocab_size), TIE_MARGIN) == 1.0


def test_generate_frequency_penalty_forbids_repeats(llama):
    """tests/test_penalties.py's case on the port: a huge frequency penalty
    makes every generated token distinct, where greedy repeats."""
    prompt = np.asarray([[1, 2, 3]], np.int32)
    out = generate(llama["model"], prompt, 16,
                   sampler=SamplerConfig(frequency_penalty=1e4))[0]
    assert len(set(out.tolist())) == 16, out
    base = generate(llama["model"], prompt, 16)[0]
    assert len(set(base.tolist())) < 16, base


def test_generate_neutral_penalties_equal_default(llama):
    prompt = np.asarray([[4, 5, 6]], np.int32)
    a = generate(llama["model"], prompt, 8,
                 sampler=SamplerConfig(temperature=0.8), seed=3)
    b = generate(llama["model"], prompt, 8, sampler=SamplerConfig(
        temperature=0.8, repeat_penalty=1.0, presence_penalty=0.0), seed=3)
    assert torch.equal(a, b)


def test_one_seed_reproduces_its_tokens(llama):
    prompt = np.asarray([[4, 5, 6]], np.int32)
    sampler = SamplerConfig(temperature=0.8, top_k=40, top_p=0.95,
                            min_p=0.05, repeat_penalty=1.1)
    runs = [generate(llama["model"], prompt, 24, sampler=sampler, seed=s)
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert len(set(runs[0][0].tolist())) > 4   # the draws move step to step


def test_impl_names_the_model_it_takes(llama):
    prompt = np.asarray([[4, 5, 6]], np.int32)
    kernel = generate(llama["model"], prompt, 6, impl="pallas")
    assert torch.equal(generate(llama["plain"], prompt, 6, impl="xla"), kernel)
    with pytest.raises(ValueError, match="plain"):
        generate(llama["model"], prompt, 6, impl="xla")
    with pytest.raises(ValueError, match="plain"):
        generate(llama["plain"], prompt, 6, impl="auto")
    with pytest.raises(ValueError, match="impl"):
        generate(llama["model"], prompt, 6, impl="mosaic")


def test_batch_must_match_the_prompt(llama):
    prompt = np.asarray([[4, 5, 6], [7, 8, 9]], np.int32)
    assert generate(llama["model"], prompt, 4, batch=2).shape == (2, 4)
    with pytest.raises(ValueError, match="batch"):
        generate(llama["model"], prompt, 4, batch=1)


def test_decode_loop_stats_on_the_cpu(llama):
    cfg, model = llama["cfg"], llama["model"]
    cache = KVCache.create(cfg, 1, 16, device="cpu")
    stats = {}
    toks, cache = decode_loop(model, torch.tensor([3], dtype=torch.int32),
                              cache, 5, stats=stats)
    assert toks.shape == (1, 5) and stats == {"graph": False, "replays": 0}
    assert int(cache.pos[0]) == 5


class _OnCard(Llama):
    """A CPU model that reports the card as its device, so decode_loop
    takes its graph branch."""
    device = property(lambda self: torch.device("cuda"))


class _FakeEvent:
    def __init__(self, **kw):
        pass

    def record(self):
        pass


def _card_branch(monkeypatch, fail=False):
    """decode_loop's graph branch on the CPU: the capture replaced by a
    stand-in that runs the step once (the loop's eager first step) and
    whose replay runs it again, as a captured graph replays it; with
    fail, the capture raises after the first step.  -> the forward
    calls, counted."""
    import tmac_tpu_torch.runtime.generate as tg
    calls = []

    class Replayed:
        def __init__(self, step):
            self.replay = step

    def capture(step, generator, device):
        assert device.type == "cpu"   # the first tokens' device
        step()
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        return Replayed(step)
    monkeypatch.setattr(tg, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    forward = Llama.forward

    def counted(self, *a, **k):
        calls.append(1)
        return forward(self, *a, **k)
    monkeypatch.setattr(Llama, "forward", counted)
    return calls


@pytest.mark.parametrize("sampler", [
    SamplerConfig(),
    SamplerConfig(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05,
                  repeat_penalty=1.1, frequency_penalty=0.2)],
    ids=["greedy", "sampled_penalized"])
def test_graph_branch_gives_the_eager_loops_tokens(llama, monkeypatch,
                                                    sampler):
    """The card's branch of decode_loop (its column index, token buffer,
    counts and generator used from a replayed step) gives the CPU loop's
    tokens and cache, from the same seed."""
    cfg = llama["cfg"]
    params = init_params(cfg, 0, "cpu")
    runs = []
    for model in (Llama(cfg, params), _OnCard(cfg, params)):
        if isinstance(model, _OnCard):
            calls = _card_branch(monkeypatch)
        cache = KVCache.create(cfg, 2, 32, device="cpu")
        stats = {}
        first = torch.tensor([3, 7], dtype=torch.int32)
        toks, cache = decode_loop(model, first, cache, 9, sampler,
                                  torch.Generator().manual_seed(4),
                                  stats=stats)
        runs.append((toks, cache, stats))
    (a, ca, sa), (b, cb, sb) = runs
    assert torch.equal(a, b) and torch.equal(ca.k, cb.k)
    assert ca.pos.tolist() == cb.pos.tolist() == [9, 9]
    assert sa == {"graph": False, "replays": 0}
    assert sb["graph"] and sb["replays"] == 8 and len(calls) == 9


def test_graph_branch_raises_when_the_capture_fails(llama, monkeypatch):
    """No fallback: a capture that fails raises out of decode_loop, after
    the loop's one eager step."""
    cfg = llama["cfg"]
    model = _OnCard(cfg, init_params(cfg, 0, "cpu"))
    calls = _card_branch(monkeypatch, fail=True)
    cache = KVCache.create(cfg, 1, 32, device="cpu")
    with pytest.raises(RuntimeError, match="capturing"):
        decode_loop(model, torch.tensor([3], dtype=torch.int32), cache, 8)
    assert len(calls) == 1


PPL_CASES = [
    ("bitnet-3b", 16, 8, 40),      # four overlapping windows, K1 route
    ("bitnet-3b", 72, None, 80),   # one window on the N >= 64 route (K3)
    ("llama-2-7b", 16, None, 40),  # two windows, K4
    ("llama-2-7b", 72, None, 80),  # K4L
]


def _perplexities(bitnet, llama, name, window, stride, length):
    run = bitnet if name == "bitnet-3b" else llama
    stream = np.random.default_rng(window).integers(0, run["cfg"].vocab_size,
                                                   length)
    got = perplexity(run["model"], stream, window, stride)
    want = jppl.perplexity(run["jparams"], run["jcfg"], stream, window,
                           stride, impl="pallas")
    assert got["tokens"] == want["tokens"] == \
        (window - 1) * len(range(0, length - window + 1, stride or window))
    assert np.isclose(got["ppl"], np.exp(got["nll"]))
    return got, want, run["model"], stream


@pytest.mark.parametrize("name, window, stride, length", PPL_CASES)
def test_perplexity_matches_jax(bitnet, llama, name, window, stride, length):
    got, want, model, stream = _perplexities(bitnet, llama, name, window,
                                             stride, length)
    assert abs(got["nll"] - want["nll"]) <= SCORE_REL * want["nll"]
    with pytest.raises(ValueError, match="too short"):
        perplexity(model, stream[:window - 1], window)
    with pytest.raises(ValueError, match="out of range"):
        perplexity(model, stream + model.cfg.vocab_size, window)


@pytest.mark.parametrize("name, window, stride, length", PPL_CASES)
def test_perplexity_gap_is_xla_rsqrt(bitnet, llama, name, window, stride,
                                     length, monkeypatch):
    _given_xla_rsqrt(monkeypatch)
    got, want, _, _ = _perplexities(bitnet, llama, name, window, stride,
                                    length)
    assert abs(got["nll"] - want["nll"]) <= GIVEN_RSQRT_REL * want["nll"]


@pytest.mark.parametrize("name", ["bitnet-3b", "llama-2-7b"])
def test_score_continuations_matches_jax(bitnet, llama, name):
    run = bitnet if name == "bitnet-3b" else llama
    rng = np.random.default_rng(5)
    V = run["cfg"].vocab_size
    context = rng.integers(0, V, 6).tolist()
    conts = [rng.integers(0, V, n).tolist() for n in (1, 3, 5)]
    # one continuation that is the model's own greedy decoding
    greedy = generate(run["model"], np.asarray([context]), 4)[0].tolist()
    conts.append(greedy)
    got = score_continuations(run["model"], context, conts)
    want = jppl.score_continuations(run["jparams"], run["jcfg"], context,
                                    conts, impl="pallas")
    assert [g["greedy"] for g in got] == [w["greedy"] for w in want]
    assert got[-1]["greedy"] and not any(g["greedy"] for g in got[:-1])
    for g, w in zip(got, want):
        assert abs(g["logprob"] - w["logprob"]) <= SCORE_REL * abs(w["logprob"])
    with pytest.raises(ValueError, match="non-empty"):
        score_continuations(run["model"], context, [[]])
