"""The port's speculative decoding (tmac_tpu_torch/runtime/speculative.py)
against the JAX package's (tmac_tpu/runtime/speculative.py) on the CPU, at
llama-2-7b scaled(8) as tests/test_speculative.py, the port given XLA's
rsqrt values (tests/test_torch_model.py::_given_xla_rsqrt) and JAX run
with impl="pallas" (interpret mode), in the manner of
tests/test_torch_engine_jax.py.  A counterpart of every test and case of
tests/test_speculative.py: each greedy stream teacher-forced to JAX's
forward (tie-aware argmax agreement 1.0 at TIE_MARGIN 1e-2, the model gate
of tests/test_torch_model.py), equal to JAX's speculative stream (and
then its forward counts) up to a first divergence that must be such a
tie, and within the forward-count bounds JAX asserts.  Beyond them: the
proposal against JAX's on random and periodic buffers, the burst
arithmetic against a step-by-step simulation of JAX's loop condition, the
graph branch on the CPU through a stand-in for the capture, and the
refusals."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine_jax import _jax_teacher_forced, _onehot
from tests.test_torch_model import _given_xla_rsqrt
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.runtime import engine as je
from tmac_tpu.runtime import speculative as jsp
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.runtime import speculative as sp
from tmac_tpu_torch.runtime.engine import InferenceEngine
from tmac_tpu_torch.runtime.generate import generate, prefill
from tmac_tpu_torch.utils import argmax_agreement

torch.set_num_threads(2)

TIE_MARGIN = 1e-2


def _side(jcfg, seed, cfg=None):
    """JAX's params at jcfg and seed, and the port's model on them."""
    jparams = jl.init_params(jcfg, seed=seed)
    cfg = cfg or get_preset(jcfg.name).scaled(8)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, model=Llama(cfg, params))


@pytest.fixture(scope="module")
def llama():
    return _side(jax_preset("llama-2-7b").scaled(8), 0)


@pytest.fixture(scope="module")
def weak_draft(llama):
    """test_speculative.py's weak draft: llama-2-7b scaled(16) on the
    target's vocabulary, seed 7."""
    jcfg = dataclasses.replace(jax_preset("llama-2-7b").scaled(16),
                               vocab_size=llama["jcfg"].vocab_size)
    cfg = dataclasses.replace(get_preset("llama-2-7b").scaled(16),
                              vocab_size=llama["cfg"].vocab_size)
    return _side(jcfg, 7, cfg)


def _hold(side, prompt, got, jgot, max_len):
    """got (a port stream, its first token first) teacher-forced to JAX's
    forward: argmax agreement 1.0 (ties allowed); equal to JAX's stream
    jgot up to the first divergence, which must sit at such a tie.  ->
    whether the two streams are equal throughout."""
    ref = _jax_teacher_forced(side, prompt, got, max_len)
    V = side["cfg"].vocab_size
    assert argmax_agreement(ref, _onehot(got, V), TIE_MARGIN) == 1.0
    d = next((i for i, (a, b) in enumerate(zip(got, jgot)) if a != b), None)
    if d is not None:
        top2 = np.sort(ref[d])[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, (d, got, jgot)
    return d is None


def _prompt(kind, V, T=24):
    rng = np.random.default_rng(0)
    if kind == "repetitive":
        return np.tile(rng.integers(0, V, 6), T // 6 + 1)[:T][None, :]
    return rng.integers(0, V, (1, T))


def test_propose_ngram():
    buf = torch.zeros((64,), dtype=torch.long)
    buf[:12] = torch.tensor([7, 8, 9, 1, 2, 3, 4, 5, 6, 1, 2, 3])
    # the trailing 3-gram [1, 2, 3] occurred at 3: the draft follows it
    draft, found = sp._propose_ngram(buf, 12, 3, 4)
    assert bool(found) and draft.tolist() == [4, 5, 6, 1]
    draft, found = sp._propose_ngram(buf, 6, 3, 4)
    assert not bool(found) and draft.tolist() == [-1] * 4


@pytest.mark.parametrize("kind", ["random", "periodic"])
def test_propose_ngram_equals_jax(kind):
    """Drafts and found flags equal JAX's at every length, n and k."""
    rng = np.random.default_rng(3)
    S = 96
    if kind == "random":
        seq = rng.integers(0, 6, S)
    else:
        seq = np.tile(rng.integers(0, 50, 5), S // 5 + 1)[:S]
    buf = np.zeros((S,), np.int64)
    buf[:80] = seq[:80]
    jpn = jax.jit(jsp._propose_ngram, static_argnums=(2, 3))
    for n, k in ((3, 8), (2, 4), (4, 5)):
        for length in range(1, 81, 3):
            d, f = sp._propose_ngram(torch.from_numpy(buf), length, n, k)
            jd, jf = jpn(jnp.asarray(buf, jnp.int32), jnp.int32(length), n, k)
            assert d.tolist() == np.asarray(jd).tolist(), (n, k, length)
            assert bool(f) == bool(jf)


@pytest.mark.parametrize("prompt_kind", ["repetitive", "random"])
def test_speculative_greedy_lossless(llama, prompt_kind, monkeypatch):
    """The lookup stream is the model's own greedy stream (teacher-forced to
    JAX), JAX's speculative stream and forward count, and the port's
    decode_loop stream, whatever the drafts."""
    _given_xla_rsqrt(monkeypatch)
    model = llama["model"]
    V, S, steps = llama["cfg"].vocab_size, 128, 24
    prompt = _prompt(prompt_kind, V)
    toks = torch.from_numpy(prompt)
    cache = KVCache.create(llama["cfg"], 1, S, device="cpu")
    logits, cache = prefill(model, toks, cache)
    first = logits.float().argmax(-1).to(torch.int32)
    out, nf, _ = sp.decode_loop_speculative(model, first, cache, toks, steps,
                                            ngram=3, k=4)
    got = out[0].tolist()
    jout, jnf = jsp.generate_speculative(llama["jparams"], llama["jcfg"],
                                         jnp.asarray(prompt, jnp.int32), steps,
                                         max_len=S, ngram=3, k=4, impl="pallas")
    if _hold(llama, prompt[0].tolist(), got, np.asarray(jout)[0].tolist(), S):
        assert nf == jnf
    plain = generate(llama["model"], prompt, steps, max_len=S)[0].tolist()
    _hold(llama, prompt[0].tolist(), got, plain, S)
    # every forward emits at least one token; the first one is free
    assert 1 <= nf <= steps - 1


def test_speculative_accepts_on_repetitive_stream(monkeypatch):
    """0 layers and a tied head: argmax(norm(embed[t]) @ embed.T) == t, so
    the stream repeats its last prompt token and, once the n-gram warms up,
    every round accepts the whole draft; the forward count equals JAX's."""
    _given_xla_rsqrt(monkeypatch)
    jcfg = dataclasses.replace(jax_preset("llama-2-7b").scaled(8), num_layers=0,
                               tie_word_embeddings=True)
    cfg = dataclasses.replace(get_preset("llama-2-7b").scaled(8), num_layers=0,
                              tie_word_embeddings=True)
    side = _side(jcfg, 2, cfg)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8))
    steps, k = 24, 4
    out, nf = sp.generate_speculative(side["model"], prompt, steps, k=k)
    toks = out[0].tolist()
    assert toks == [toks[0]] * steps
    assert nf <= 3 + (steps + k) // (k + 1)
    jout, jnf = jsp.generate_speculative(side["jparams"], jcfg,
                                         jnp.asarray(prompt, jnp.int32), steps, k=k,
                                         impl="pallas")
    assert toks == np.asarray(jout)[0].tolist() and nf == jnf


def test_engine_speculative_mode_matches_plain(llama, monkeypatch):
    """InferenceEngine(speculative=True): the greedy stream equals the
    port's plain engine's and JAX's speculative engine's (teacher-forced as
    above), near the budget it still ends right, and a sampled request
    takes the normal path."""
    _given_xla_rsqrt(monkeypatch)
    V = llama["cfg"].vocab_size
    prompt = np.tile(np.random.default_rng(3).integers(0, V, 5), 4).tolist()
    kw = dict(max_batch=1, max_len=128, decode_chunk=8)
    plain = InferenceEngine(llama["model"], **kw)
    u = plain.submit(prompt, max_new_tokens=24)
    want = plain.run()[u]
    spec = InferenceEngine(llama["model"], speculative=True, **kw)
    u = spec.submit(prompt, max_new_tokens=24)
    got = spec.run()[u]
    assert len(got) == 24 and spec.stats["spec_forwards"] > 0
    jeng = je.InferenceEngine(llama["jcfg"], llama["jparams"], impl="pallas",
                              speculative=True, **kw)
    ju = jeng.submit(prompt, max_new_tokens=24)
    jgot = jeng.run()[ju]
    _hold(llama, prompt, got, jgot, 128)
    _hold(llama, prompt, got, want, 128)
    forwards = spec.stats["spec_forwards"]
    u3 = spec.submit(prompt, max_new_tokens=8, temperature=0.9)
    out3 = spec.run()[u3]
    assert len(out3) == 8 and all(0 <= t < V for t in out3)
    assert spec.stats["spec_forwards"] == forwards


@pytest.mark.parametrize("draft_kind", ["weak", "self"])
def test_draft_speculative_greedy_lossless(llama, weak_draft, draft_kind, monkeypatch):
    """Draft-model speculation emits the target's own greedy stream for any
    draft (teacher-forced; JAX's stream and counts); k draft forwards a
    round; a self-draft accepts nearly everything."""
    _given_xla_rsqrt(monkeypatch)
    d = llama if draft_kind == "self" else weak_draft
    V, S, steps, k = llama["cfg"].vocab_size, 128, 20, 4
    prompt = np.random.default_rng(1).integers(0, V, (1, 16))
    out, nft, nfd = sp.generate_draft_speculative(llama["model"], d["model"], prompt,
                                                  steps, max_len=S, k=k)
    got = out[0].tolist()
    jout, jnft, jnfd = jsp.generate_draft_speculative(
        llama["jparams"], llama["jcfg"], d["jparams"], d["jcfg"],
        jnp.asarray(prompt, jnp.int32), max_new_tokens=steps, max_len=S, k=k,
        impl="pallas")
    if _hold(llama, prompt[0].tolist(), got, np.asarray(jout)[0].tolist(), S):
        assert (nft, nfd) == (jnft, jnfd)
    assert nfd == k * nft
    if draft_kind == "self":
        assert nft <= math.ceil((steps - 1) / k) + 1, nft


def _jax_cond_rounds(steps, S, k, per_round, emits, length):
    """The reference's while_loop, step by step: the rounds it runs, each
    emitting min(its draw, the budget left), at least 1."""
    emitted, rounds = 1, 0
    while emitted < steps and length + k + 1 <= S:
        n = max(min(emits[rounds], steps - emitted), 1)
        emitted, length, rounds = emitted + n, length + n, rounds + 1
    return rounds


@pytest.mark.parametrize("per_round_of", ["lookup", "draft"])
def test_burst_rounds_run_the_reference_rounds(per_round_of):
    """Bursts of burst_rounds rounds, with a host check only between
    bursts, run exactly the rounds JAX's cond runs, and every one of them
    finds the cond true, whatever each round emits."""
    rng = np.random.default_rng(11)
    for _ in range(300):
        k = int(rng.integers(1, 10))
        per_round = k + 1 if per_round_of == "lookup" else k
        steps = int(rng.integers(1, 80))
        length = int(rng.integers(1, 60))
        S = length + int(rng.integers(0, 120))
        emits = rng.integers(1, per_round + 1, 400)
        emitted, ln, rounds = 1, length, 0
        while (r := sp.burst_rounds(steps, emitted, ln, S, k, per_round)) > 0:
            for _ in range(r):
                assert emitted < steps and ln + k + 1 <= S
                n = max(min(int(emits[rounds]), steps - emitted), 1)
                emitted, ln, rounds = emitted + n, ln + n, rounds + 1
        assert rounds == _jax_cond_rounds(steps, S, k, per_round, emits, length)


class _FakeEvent:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def _stand_in_capture(monkeypatch, fail=False):
    """The card's capture on the CPU: the stand-in runs the round once (the
    warm-up, a real round) and its replay runs it again, as a graph
    replays it; with fail, it raises after the warm-up."""
    class Replayed:
        def __init__(self, fn):
            self.replay = fn

    def capture(fn, generator, device):
        fn()
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        return Replayed(fn)
    monkeypatch.setattr(sp, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)


@pytest.mark.parametrize("variant", ["lookup", "draft"])
def test_graph_bursts_equal_eager_rounds(llama, weak_draft, variant, monkeypatch):
    """The card's branch (graph=True) through the stand-in: the same tokens
    and forward counts as the eager rounds, one capture, a host read per
    burst and one more."""
    _stand_in_capture(monkeypatch)
    cfg, model = llama["cfg"], llama["model"]
    prompt = torch.from_numpy(_prompt("repetitive", cfg.vocab_size))
    runs = []
    for graph in (True, False):
        cache = KVCache.create(cfg, 1, 64, device="cpu")
        logits, cache = model(prompt, cache)
        first = logits[0, -1:].argmax(-1)
        hist = sp._history(prompt, first, cache.max_len)
        st = {}
        if variant == "lookup":
            out, emitted, nf, _ = sp.decode_chunk_speculative(
                model, hist, 25, cache, 30, k=4, stats=st, graph=graph)
            nfd = 0
        else:
            dm = weak_draft["model"]
            cd = KVCache.create(dm.cfg, 1, 64, device="cpu")
            dm(prompt, cd)
            out, emitted, nf, nfd, _, _ = sp.decode_chunk_draft_speculative(
                model, dm, hist, 25, cache, cd, 30, k=4, stats=st, graph=graph)
        runs.append((out.tolist(), emitted, nf, nfd, st))
    (g, e) = runs
    assert g[:4] == e[:4]
    st = g[4]
    assert st["graph"] and st["captured"] and st["replays"] + st["eager_rounds"] == g[2]
    assert st["host_syncs"] == st["bursts"] + 1 and len(st["replay_events"]) >= 1
    assert not e[4]["graph"] and e[4]["replays"] == 0


def test_failed_capture_raises(llama, monkeypatch):
    """No fallback: a capture that fails raises out of the run."""
    _stand_in_capture(monkeypatch, fail=True)
    cfg, model = llama["cfg"], llama["model"]
    prompt = torch.from_numpy(_prompt("random", cfg.vocab_size))
    cache = KVCache.create(cfg, 1, 64, device="cpu")
    model(prompt, cache)
    hist = sp._history(prompt, torch.tensor([5]), cache.max_len)
    with pytest.raises(RuntimeError, match="capturing"):
        sp.decode_chunk_speculative(model, hist, 25, cache, 30, k=4, graph=True)


def test_refusals(llama, weak_draft):
    """Single-stream, one vocabulary, the engine's mode at one slot and
    without step_fns: each refused with a ValueError."""
    model, V = llama["model"], llama["cfg"].vocab_size
    with pytest.raises(ValueError, match="single-stream"):
        sp.generate_speculative(model, np.zeros((2, 4), np.int64), 4)
    with pytest.raises(ValueError, match="out of range"):
        sp.generate_speculative(model, np.asarray([[V]]), 4)
    ocfg = dataclasses.replace(get_preset("llama-2-7b").scaled(16), vocab_size=256)
    other = Llama(ocfg, init_params(ocfg, 1, device="cpu"))
    with pytest.raises(ValueError, match="vocabulary"):
        sp.generate_draft_speculative(model, other, np.asarray([[1, 2, 3]]), 4)
    with pytest.raises(ValueError, match="max_batch=1"):
        InferenceEngine(model, max_batch=2, speculative=True)
    with pytest.raises(ValueError, match="max_batch=1"):
        InferenceEngine(model, max_batch=1, speculative=True, step_fns=(None, None))
    with pytest.raises(ValueError, match="impl"):
        sp.generate_speculative(model, np.asarray([[1, 2, 3]]), 4, impl="xla")
