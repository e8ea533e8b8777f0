"""The port's continuous-batching engine (tmac_tpu_torch/runtime/engine.py)
on the CPU, at llama-2-7b scaled(8), the fixture of tests/test_engine.py.

First that file's tests on the port (all but the two mesh tests, which
come with parallel/): a request's tokens equal the port's own single-
stream greedy generate exactly, whatever shares the batch.  Then the
port's own forms: the refused speculative mode, impl, step_fns, and the
counter-based draws.  tests/test_torch_engine_jax.py holds the engine
against the JAX package's."""

import functools

import numpy as np
import pytest
import torch

from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import Llama, init_params
from tmac_tpu_torch.runtime import engine as te
from tmac_tpu_torch.runtime.engine import InferenceEngine
from tmac_tpu_torch.runtime.generate import generate
from tmac_tpu_torch.runtime.perplexity import score_continuations
from tmac_tpu_torch.runtime.sampling import CounterStreams, SamplerConfig

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def model():
    cfg = get_preset("llama-2-7b").scaled(8)
    return Llama(cfg, init_params(cfg, seed=0, device="cpu"))


def _reference(model, prompt, n):
    return generate(model, np.asarray([prompt], np.int32), n)[0].tolist()


# ------------------------------------------------ tests/test_engine.py's


def test_single_request_matches_single_stream(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    uid = eng.submit([1, 2, 3], max_new_tokens=8)
    assert eng.run()[uid] == _reference(model, [1, 2, 3], 8)


def test_concurrent_requests_are_isolated(model):
    eng = InferenceEngine(model, max_batch=4, max_len=64, decode_chunk=4)
    prompts = [[1, 2, 3], [7, 8], [9, 10, 11, 12, 13], [4]]
    uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    results = eng.run()
    for uid, p in zip(uids, prompts):
        assert results[uid] == _reference(model, p, 6), f"prompt {p}"


def test_more_requests_than_slots(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    prompts = [[i + 1, i + 2] for i in range(5)]
    lens = [3, 9, 5, 2, 7]
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, lens)]
    results = eng.run()
    assert len(results) == 5
    for uid, p, n in zip(uids, prompts, lens):
        assert results[uid] == _reference(model, p, n)


def test_eos_stops_generation(model):
    ref = _reference(model, [5, 6], 4)
    eos = ref[2]
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    uid = eng.submit([5, 6], max_new_tokens=16, eos_id=eos)
    assert eng.run()[uid] == ref[:ref.index(eos) + 1]


def test_slot_reuse_is_clean(model):
    eng = InferenceEngine(model, max_batch=1, max_len=64, decode_chunk=4)
    eng.submit([9, 9, 9], max_new_tokens=5)
    eng.run()
    u2 = eng.submit([1, 2, 3], max_new_tokens=8)
    assert eng.run()[u2] == _reference(model, [1, 2, 3], 8)


def test_stream_callback_and_stats(model):
    events = []
    eng = InferenceEngine(
        model, max_batch=2, max_len=64, decode_chunk=2,
        stream_cb=lambda u, t, done: events.append((u, list(t), done)))
    uid = eng.submit([1, 2], max_new_tokens=7)
    results = eng.run()
    assert all(u == uid for u, _, _ in events)
    assert len(events) >= 3
    assert [done for _, _, done in events][:-1] == [False] * (len(events) - 1)
    assert events[-1][2] is True and events[-1][1] == results[uid]
    for (_, a, _), (_, b, _) in zip(events, events[1:]):
        assert b[:len(a)] == a and len(b) > len(a)
    assert eng.stats["prefills"] == 1
    assert eng.stats["prefill_tokens"] == 2
    assert eng.stats["decode_tokens"] >= 6


def test_per_request_sampling(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    ug = eng.submit([1, 2, 3], max_new_tokens=8)
    us = eng.submit([4, 5], max_new_tokens=8, temperature=0.9, top_k=40)
    results = eng.run()
    assert results[ug] == _reference(model, [1, 2, 3], 8)
    assert len(results[us]) == 8
    assert all(0 <= t < model.cfg.vocab_size for t in results[us])
    u0 = eng.submit([1, 2, 3], max_new_tokens=8, temperature=0.0)
    assert eng.run()[u0] == _reference(model, [1, 2, 3], 8)
    assert eng._n_dynamic == 0 and not eng._dynamic_sampling
    uc = eng.submit([7], max_new_tokens=4, temperature=0.5)
    assert eng._n_dynamic == 1
    eng.cancel(uc)
    assert eng._n_dynamic == 0


def test_mid_chunk_eos_freezes_slot(model):
    ref = _reference(model, [5, 6], 8)
    eos = ref[2]
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=16)
    uid = eng.submit([5, 6], max_new_tokens=16, eos_id=eos)
    results = eng.run()
    assert results[uid] == ref[:ref.index(eos) + 1]
    # pos froze at the eos step: prompt + decode steps = prompt + output - 1
    assert int(eng.cache.pos[0]) == 2 + len(results[uid]) - 1


def test_sampled_decode_in_range(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4,
                          sampler=SamplerConfig(temperature=0.9, top_k=40))
    uid = eng.submit([3, 4, 5], max_new_tokens=6)
    results = eng.run()
    assert len(results[uid]) == 6
    assert all(0 <= t < model.cfg.vocab_size for t in results[uid])


def test_submit_validation(model):
    """Outside input is checked with ValueError (JAX asserts)."""
    eng = InferenceEngine(model, max_batch=1, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(30)), max_new_tokens=10)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([model.cfg.vocab_size], max_new_tokens=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=1)


def test_admission_does_not_stall_decodes(model):
    eng = InferenceEngine(model, max_batch=2, max_len=128, decode_chunk=2,
                          prefill_chunk=8)
    ua = eng.submit([1, 2, 3], max_new_tokens=20)
    eng.step()
    assert eng.slots[0] is not None and not eng.slots[0].prefilling
    tokens_before = len(eng.slots[0].output)
    long_prompt = [int(t) for t in
                   np.random.default_rng(3).integers(1, model.cfg.vocab_size, 32)]
    ub = eng.submit(long_prompt, max_new_tokens=4)

    def b_pending():
        return bool(eng.waiting) or any(
            r is not None and r.prefilling for r in eng.slots)

    interleaved = 0
    for _ in range(50):
        if not b_pending():
            break
        na = len(eng.slots[0].output) if eng.slots[0] is not None else 0
        eng.step()
        if eng.slots[0] is not None and len(eng.slots[0].output) > na:
            interleaved += 1
    assert interleaved >= 3, "decode stalled during chunked admission"
    assert len(eng.slots[0].output) > tokens_before
    results = eng.run()
    assert results[ua] == _reference(model, [1, 2, 3], 20)
    assert results[ub] == _reference(model, long_prompt, 4)


def test_cancel_frees_slot_and_queue(model):
    eng = InferenceEngine(model, max_batch=1, max_len=64, decode_chunk=2)
    u1 = eng.submit([1, 2, 3], max_new_tokens=30)
    u2 = eng.submit([4, 5], max_new_tokens=5)
    eng.step()
    assert eng.cancel(u1)
    assert not eng.cancel(9999)
    results = eng.run()
    assert u1 not in results
    assert results[u2] == _reference(model, [4, 5], 5)


def test_chunked_prefill_matches_oneshot(model):
    prompt = [int(t) for t in
              np.random.default_rng(7).integers(1, model.cfg.vocab_size, 40)]
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4,
                          prefill_chunk=16)
    uid = eng.submit(prompt, max_new_tokens=6)
    results = eng.run()
    assert eng.stats["prefills"] == 1 and eng.stats["prefill_tokens"] == 40
    assert results[uid] == _reference(model, prompt, 6)


def test_prefix_cache_reuse_and_equality(model):
    rng = np.random.default_rng(11)
    shared = [int(t) for t in rng.integers(1, model.cfg.vocab_size, 24)]
    pa = shared + [3, 1, 4, 1, 5]
    pb = shared + [9, 2, 6, 5, 3]
    eng = InferenceEngine(model, max_batch=2, max_len=128, decode_chunk=4,
                          prefill_chunk=16, prefix_cache_size=4,
                          prefix_cache_min_reuse=4)
    ua = eng.submit(pa, max_new_tokens=6)
    ra = eng.run()[ua]
    assert eng.stats["prefix_hits"] == 0
    ub = eng.submit(pb, max_new_tokens=6)
    rb = eng.run()[ub]
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_tokens_reused"] == len(shared)
    ua2 = eng.submit(pa, max_new_tokens=6)
    ra2 = eng.run()[ua2]
    assert eng.stats["prefix_hits"] == 2
    assert eng.stats["prefix_tokens_reused"] == len(shared) + len(pa) - 1
    assert ra == _reference(model, pa, 6)
    assert rb == _reference(model, pb, 6)
    assert ra2 == ra


def test_warmup_preserves_outputs(model):
    rng = np.random.default_rng(23)
    shared = [int(t) for t in rng.integers(1, model.cfg.vocab_size, 20)]
    prompts = [shared + [int(t) for t in rng.integers(1, model.cfg.vocab_size, 6)]
               for _ in range(3)]

    def run(warm: bool, temperature: float):
        eng = InferenceEngine(model, max_batch=2, max_len=128, decode_chunk=4,
                              prefill_chunk=16, prefix_cache_size=4,
                              prefix_cache_min_reuse=4,
                              sampler=SamplerConfig(temperature=temperature,
                                                    top_k=5), seed=7)
        if warm:
            eng.warmup()
        outs = []
        for p in prompts:
            u = eng.submit(p, max_new_tokens=5)
            outs.append(eng.run()[u])
        return outs, eng.stats["prefix_hits"]

    for temp in (0.0, 0.8):
        cold, hits_c = run(False, temp)
        warm, hits_w = run(True, temp)
        assert warm == cold, (temp, cold, warm)
        assert hits_c == hits_w == 2


def test_prefix_cache_lru_eviction(model):
    eng = InferenceEngine(model, max_batch=1, max_len=64, decode_chunk=4,
                          prefix_cache_size=2, prefix_cache_min_reuse=2)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, model.cfg.vocab_size, 8)]
               for _ in range(3)]
    for p in prompts:
        eng.submit(p, max_new_tokens=2)
        eng.run()
    assert len(eng._prefixes) == 2
    u = eng.submit(prompts[2], max_new_tokens=2)
    r = eng.run()[u]
    assert eng.stats["prefix_hits"] == 1
    assert r == _reference(model, prompts[2], 2)


def test_stop_tokens_truncate_and_finish(model):
    ref = _reference(model, [1, 2, 3], 8)
    stop = ref[2:4]
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    uid = eng.submit([1, 2, 3], max_new_tokens=8, stop_tokens=[stop])
    uid2 = eng.submit([1, 2, 3], max_new_tokens=8,
                      stop_tokens=[[model.cfg.vocab_size - 1] * 2])
    results = eng.run()
    assert results[uid] == ref[:2]
    assert eng.finished[uid].finish_reason == "stop"
    assert results[uid2] == ref
    assert eng.finished[uid2].finish_reason == "length"


def test_stop_tokens_first_token(model):
    ref = _reference(model, [1, 2, 3], 4)
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    uid = eng.submit([1, 2, 3], max_new_tokens=4, stop_tokens=[[ref[0]]])
    assert eng.run()[uid] == []
    assert eng.finished[uid].finish_reason == "stop"


def test_finish_reason_eos(model):
    ref = _reference(model, [4, 5], 8)
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    uid = eng.submit([4, 5], max_new_tokens=8, eos_id=ref[3])
    assert eng.run()[uid] == ref[:ref.index(ref[3]) + 1]
    assert eng.finished[uid].finish_reason == "eos"


def test_logprobs_match_teacher_forced_scoring(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4,
                          logprobs_k=4)
    uid = eng.submit([1, 2, 3], max_new_tokens=7, logprobs=3)
    out = eng.run()[uid]
    req = eng.finished[uid]
    assert len(req.logprobs_out) == len(out) == 7
    for rec in req.logprobs_out:
        assert len(rec["top"]) == 3
        assert abs(rec["logprob"] - rec["top"][0][1]) < 1e-6
        vals = [v for _, v in rec["top"]]
        assert vals == sorted(vals, reverse=True)
    total = sum(r["logprob"] for r in req.logprobs_out)
    ref = score_continuations(model, [1, 2, 3], [out])
    assert abs(total - ref[0]["logprob"]) < 2e-3, (total, ref)
    assert ref[0]["greedy"]


def test_logprobs_mixed_batch_and_isolation(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    u1 = eng.submit([1, 2, 3], max_new_tokens=6, logprobs=2)
    u2 = eng.submit([7, 8], max_new_tokens=6)
    res = eng.run()
    assert res[u1] == _reference(model, [1, 2, 3], 6)
    assert res[u2] == _reference(model, [7, 8], 6)
    assert len(eng.finished[u1].logprobs_out) == 6
    assert eng.finished[u2].logprobs_out == []


def test_logprobs_with_stop_truncation(model):
    ref = _reference(model, [1, 2, 3], 8)
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    uid = eng.submit([1, 2, 3], max_new_tokens=8, logprobs=2,
                     stop_tokens=[ref[2:4]])
    assert eng.run()[uid] == ref[:2]
    assert len(eng.finished[uid].logprobs_out) == 2


def test_per_request_seed_reproducible(model):
    def run(extra_prompts, seed=42):
        eng = InferenceEngine(model, max_batch=4, max_len=64, decode_chunk=4)
        for p in extra_prompts:
            eng.submit(p, max_new_tokens=8, temperature=1.3)
        uid = eng.submit([1, 2, 3], max_new_tokens=8, temperature=0.9,
                         seed=seed)
        return eng.run()[uid]

    alone = run([])
    crowded = run([[5, 6], [7, 8, 9], [4]])  # the seeded request in slot 3
    assert alone == crowded
    assert len(alone) == 8
    assert run([], seed=7) != alone


def test_seed_with_greedy_matches_reference(model):
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4)
    u1 = eng.submit([1, 2, 3], max_new_tokens=6, temperature=0.0, seed=123)
    u2 = eng.submit([7, 8], max_new_tokens=6)
    res = eng.run()
    assert res[u1] == _reference(model, [1, 2, 3], 6)
    assert res[u2] == _reference(model, [7, 8], 6)


def test_adaptive_decode_chunk_token_equality(model):
    prompt, n = [5, 6, 7], 48

    def run(**kw):
        eng = InferenceEngine(model, max_batch=2, max_len=128, decode_chunk=4, **kw)
        uid = eng.submit(prompt, max_new_tokens=n)
        return eng.run()[uid], eng.stats["chunks"]

    base, base_chunks = run()
    grown, grown_chunks = run(max_decode_chunk=32)
    assert grown == base
    assert len(base) == n
    assert grown_chunks < base_chunks, (grown_chunks, base_chunks)


def test_adaptive_chunk_respects_stop_sequences(model):
    eng = InferenceEngine(model, max_batch=1, max_len=128, decode_chunk=4,
                          max_decode_chunk=64)
    probe = InferenceEngine(model, max_batch=1, max_len=128, decode_chunk=4)
    u0 = probe.submit([5, 6, 7], max_new_tokens=12)
    ref = probe.run()[u0]
    stop = ref[5:7]
    uid = eng.submit([5, 6, 7], max_new_tokens=12, stop_tokens=[stop])
    assert eng.run()[uid] == ref[:5]
    assert eng.stats["chunks"] >= 2


# ------------------------------------------------ the port's own forms


def test_speculative_mode_is_refused(model):
    """The speculative mode is single-stream: refused with more than one
    slot or with step_fns, taken at one slot."""
    with pytest.raises(ValueError, match="max_batch=1"):
        InferenceEngine(model, max_batch=2, max_len=64, speculative=True)
    with pytest.raises(ValueError, match="max_batch=1"):
        InferenceEngine(model, max_batch=1, max_len=64, speculative=True,
                        step_fns=(None, None))
    assert InferenceEngine(model, max_batch=1, max_len=64, speculative=True).speculative


def test_impl_is_checked(model):
    with pytest.raises(ValueError, match="plain"):
        InferenceEngine(model, max_batch=1, max_len=64, impl="xla")
    with pytest.raises(ValueError, match="impl"):
        InferenceEngine(model, max_batch=1, max_len=64, impl="mosaic")


def test_step_fns_hook(model):
    """step_fns of the documented signature replace the single-device
    steps: the module's own prefill_slot and decode_chunk give the default
    engine's tokens, penalties included (counts carried across chunks)."""
    sampler = SamplerConfig(repeat_penalty=1.3)
    prompts = [[1, 2, 3], [7, 8], [9, 10, 11, 12, 13]]

    def run(**kw):
        eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4,
                              sampler=sampler, **kw)
        uids = [eng.submit(p, max_new_tokens=7) for p in prompts]
        res = eng.run()
        return [res[u] for u in uids]
    fns = (te.prefill_slot, functools.partial(te.decode_chunk, sampler=sampler))
    assert run(step_fns=fns) == run()
    eng = InferenceEngine(model, max_batch=2, max_len=64, step_fns=fns)
    with pytest.raises(ValueError, match="single-device"):
        eng.submit([1], max_new_tokens=2, seed=1)
    with pytest.raises(ValueError, match="single-device"):
        eng.submit([1], max_new_tokens=2, logprobs=2)


def test_counter_streams_draw_the_distribution():
    """The counter-based draws: Gumbel-max over them samples softmax(logits)
    (total variation < 0.02 over 40 000 draws of a 6-way distribution),
    rows and indices give independent-looking streams, and a (seed,
    index) pair gives the same draw whatever else is in the batch."""
    from tmac_tpu_torch.runtime.sampling import _categorical
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    p = torch.softmax(logits, -1)[0].numpy()
    n = 40_000
    seeds = torch.arange(n, dtype=torch.int64) * 7919 - (1 << 40)
    draws = _categorical(CounterStreams(seeds, torch.full((n,), 3)),
                         logits.expand(n, 6))
    freq = np.bincount(draws.numpy(), minlength=6) / n
    assert 0.5 * np.abs(freq - p).sum() < 0.02
    by_index = _categorical(CounterStreams(torch.full((n,), 5),
                                           torch.arange(n)), logits.expand(n, 6))
    freq = np.bincount(by_index.numpy(), minlength=6) / n
    assert 0.5 * np.abs(freq - p).sum() < 0.02
    one = CounterStreams(torch.tensor([99]), torch.tensor([4])).exponentials(50)
    many = CounterStreams(torch.tensor([1, 99, 3]),
                          torch.tensor([4, 4, 4])).exponentials(50)
    assert torch.equal(one[0], many[1]) and not torch.equal(many[0], many[1])


def test_prefix_hit_waiting_a_tick_keeps_its_rows(model):
    """A prefix hit whose first prefill chunk waits a tick (the prefill
    budget goes to another slot first) while another slot decodes: the
    decode step's frozen write for the waiting slot lands at its pos, which
    the hit moved to the match point, so the copied rows stay whole and
    the stream is the single-stream one.  (The JAX package's engine keeps
    the slot's stale pos there, from the request before, and its frozen
    write lands inside the copied prefix.)"""
    rng = np.random.default_rng(4)
    shared = [int(t) for t in rng.integers(1, model.cfg.vocab_size, 24)]
    eng = InferenceEngine(model, max_batch=3, max_len=128, decode_chunk=4,
                          prefill_chunk=16, prefix_cache_size=4,
                          prefix_cache_min_reuse=4)
    eng.submit(shared + [1, 2, 3], max_new_tokens=2)
    eng.run()
    eng.submit([9, 9], max_new_tokens=60)           # slot 0, decoding
    ux = eng.submit([5, 6, 7], max_new_tokens=2)    # slot 1, pos 4 when done
    while ux not in eng.finished:
        eng.step()
    ur = eng.submit(shared + [8, 8], max_new_tokens=6)   # slot 1, a hit
    eng.submit([int(t) for t in rng.integers(1, model.cfg.vocab_size, 40)],
               max_new_tokens=2)                    # slot 2, prefilled first
    eng.step()
    assert eng.slots[1].prefilling and eng.slots[2].prefill_off > 0
    eng.run()
    assert eng.stats["prefix_hits"] == 1
    assert eng.finished[ur].output == _reference(model, shared + [8, 8], 6)
