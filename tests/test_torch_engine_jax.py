"""The port's continuous-batching engine against the JAX package's
(tmac_tpu/runtime/engine.py) on the CPU, at scaled(8): llama-2-7b (the
fixture of tests/test_engine.py), bitnet-3b (w_a8) and mixtral-8x7b (the
expert FFN raised to 512, as in tests/test_torch_model.py).  Both engines
take the same prompts and parameters (carried over with
convert/from_jax.py), the port given XLA's rsqrt values for the norm
factors.  Each greedy stream is held teacher-forced to JAX's
forward(impl="pallas") (tie-aware argmax agreement 1.0 over the stream,
the model gate of tests/test_torch_model.py), and to JAX's engine stream
and finish reason; logprob records within 1e-4 of JAX's and of a
teacher-forced log-softmax.  Covered: the 16 and 64 buckets and a chunked
prompt, eos mid-chunk, stop tokens, logprobs, a prefix hit on an int8
cache, and Mixtral's padded bucket rows kept out of the dispatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import _given_xla_rsqrt
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.runtime import engine as je
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import Llama
from tmac_tpu_torch.runtime.engine import InferenceEngine
from tmac_tpu_torch.runtime.generate import generate
from tmac_tpu_torch.utils import argmax_agreement

torch.set_num_threads(2)

TIE_MARGIN, LOGPROB_TOL = 1e-2, 1e-4


def _reference(model, prompt, n):
    return generate(model, np.asarray([prompt], np.int32), n)[0].tolist()


_jfwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))


def _jax_side(cfg_name, **kw):
    jcfg = jax_preset(cfg_name).scaled(8)
    cfg = get_preset(cfg_name).scaled(8)
    jcfg, cfg = (dataclasses.replace(c, **kw) for c in (jcfg, cfg))
    jparams = jl.init_params(jcfg, seed=0)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, model=Llama(cfg, params))


@pytest.fixture(scope="module")
def llama_pair():
    return _jax_side("llama-2-7b")


def _jax_teacher_forced(side, prompt, toks, max_len, quant=False):
    """JAX forward(impl="pallas") on a 1-row cache: the prompt's last
    logits, then a decode step per token of toks[:-1] -> (len(toks), V)."""
    jcfg, jparams = side["jcfg"], side["jparams"]
    cache = jl.KVCache.create(jcfg, 1, max_len, quant=quant)
    lg, cache = _jfwd(jparams, jcfg, jnp.asarray([prompt]), cache, impl="pallas")
    rows = [np.asarray(lg[0, -1])]
    for t in toks[:-1]:
        lg, cache = _jfwd(jparams, jcfg, jnp.asarray([[t]]), cache, impl="pallas")
        rows.append(np.asarray(lg[0, -1]))
    return np.stack(rows)


def _onehot(toks, V):
    out = np.zeros((len(toks), V), np.float32)
    out[np.arange(len(toks)), toks] = 1.0
    return out


def _both_engines(side, requests, monkeypatch, **kw):
    """Run `requests` [(prompt, submit kwargs)] through JAX's engine and the
    port's with the same settings (the port given XLA's rsqrt values):
    -> (jax finished requests, port finished requests, the two engines)."""
    _given_xla_rsqrt(monkeypatch)
    jeng = je.InferenceEngine(side["jcfg"], side["jparams"], impl="pallas", **kw)
    peng = InferenceEngine(side["model"], **kw)
    out = []
    for eng in (jeng, peng):
        uids = [eng.submit(p, **skw) for p, skw in requests]
        eng.run()
        out.append([eng.finished[u] for u in uids])
    return out[0], out[1], jeng, peng


def _hold_to_jax(side, requests, jreqs, preqs, max_len, quant=False):
    """Each port stream teacher-forced against JAX (tie-aware argmax 1.0
    over its tokens) and equal to the JAX engine's stream and finish
    reason."""
    V = side["cfg"].vocab_size
    for (prompt, skw), jr, pr in zip(requests, jreqs, preqs):
        if pr.output:
            ref = _jax_teacher_forced(side, prompt, pr.output, max_len, quant)
            assert argmax_agreement(ref, _onehot(pr.output, V), TIE_MARGIN) == 1.0
        assert pr.output == jr.output, (prompt, pr.output, jr.output)
        assert pr.finish_reason == jr.finish_reason


def test_engine_matches_jax_buckets_and_chunks(llama_pair, monkeypatch):
    """Prompts in the 16 and 64 buckets and one past prefill_chunk (three
    chunks), four slots, more requests than slots."""
    rng = np.random.default_rng(5)
    V = llama_pair["cfg"].vocab_size
    lens = (3, 20, 40, 150, 9)
    reqs = [([int(t) for t in rng.integers(1, V, n)], dict(max_new_tokens=6))
            for n in lens]
    kw = dict(max_batch=4, max_len=256, decode_chunk=4, prefill_chunk=64)
    jr, pr, _, peng = _both_engines(llama_pair, reqs, monkeypatch, **kw)
    assert peng.stats["prefill_chunks"] == {16: 2, 64: 5}
    _hold_to_jax(llama_pair, reqs, jr, pr, 256)


def test_engine_matches_jax_eos_stop_logprobs(llama_pair, monkeypatch):
    """eos mid-chunk, stop tokens, and logprob records within 1e-4 of
    JAX's (and of a teacher-forced log-softmax)."""
    model = llama_pair["model"]
    base = _reference(model, [1, 2, 3], 10)
    reqs = [([1, 2, 3], dict(max_new_tokens=10, eos_id=base[5])),
            ([1, 2, 3], dict(max_new_tokens=10, stop_tokens=[base[3:5]])),
            ([4, 5, 6, 7], dict(max_new_tokens=9, logprobs=4))]
    kw = dict(max_batch=3, max_len=64, decode_chunk=8, logprobs_k=4)
    jr, pr, _, _ = _both_engines(llama_pair, reqs, monkeypatch, **kw)
    assert pr[0].output == base[:base.index(base[5]) + 1]
    assert pr[0].finish_reason == "eos" and pr[1].finish_reason == "stop"
    assert pr[1].output == base[:3]
    _hold_to_jax(llama_pair, reqs, jr, pr, 64)
    recs, jrecs = pr[2].logprobs_out, jr[2].logprobs_out
    assert len(recs) == len(jrecs) == 9
    logp = jax.nn.log_softmax(jnp.asarray(_jax_teacher_forced(
        llama_pair, [4, 5, 6, 7], pr[2].output, 64)), axis=-1)
    for i, (rec, jrec) in enumerate(zip(recs, jrecs)):
        assert abs(rec["logprob"] - jrec["logprob"]) <= LOGPROB_TOL
        assert abs(rec["logprob"] - float(logp[i, pr[2].output[i]])) <= LOGPROB_TOL
        assert [t for t, _ in rec["top"]] == [t for t, _ in jrec["top"]]
        assert np.allclose([v for _, v in rec["top"]], [v for _, v in jrec["top"]],
                           atol=LOGPROB_TOL, rtol=0)


def test_engine_matches_jax_prefix_hit_and_int8_cache(llama_pair, monkeypatch):
    """A prefix hit on an int8 cache: the stored block carries the scales;
    the second request's stream is JAX's and its cold one's."""
    rng = np.random.default_rng(9)
    V = llama_pair["cfg"].vocab_size
    shared = [int(t) for t in rng.integers(1, V, 24)]
    reqs = [(shared + [3, 1, 4], dict(max_new_tokens=5)),
            (shared + [9, 2], dict(max_new_tokens=5))]
    kw = dict(max_batch=2, max_len=64, decode_chunk=4, prefill_chunk=16,
              prefix_cache_size=2, prefix_cache_min_reuse=4, kv_quant=True)
    _given_xla_rsqrt(monkeypatch)
    jeng = je.InferenceEngine(llama_pair["jcfg"], llama_pair["jparams"],
                              impl="pallas", **kw)
    peng = InferenceEngine(llama_pair["model"], **kw)
    jr, pr = [], []
    for p, skw in reqs:  # one at a time, so that the second hits
        for eng, acc in ((jeng, jr), (peng, pr)):
            u = eng.submit(p, **skw)
            eng.run()
            acc.append(eng.finished[u])
    assert peng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 1
    assert peng.stats["prefix_tokens_reused"] == len(shared)
    assert peng._prefixes[tuple(reqs[0][0])].ks is not None
    _hold_to_jax(llama_pair, reqs, jr, pr, 64, quant=True)
    cold = InferenceEngine(llama_pair["model"], **{**kw, "prefix_cache_size": 0})
    u = cold.submit(reqs[1][0], **reqs[1][1])
    assert cold.run()[u] == pr[1].output


@pytest.mark.parametrize("name", ["bitnet-3b", "mixtral-8x7b"])
def test_engine_matches_jax_other_models(name, monkeypatch):
    """BitNet (w_a8, K1) and Mixtral (MoE): a prompt in the 64 bucket,
    where Mixtral's prefill takes the capacity dispatch and the padded
    rows must take none of it (valid=False in the MoE MLP), beside short
    ones."""
    kw = dict(moe_intermediate_size=512) if name == "mixtral-8x7b" else {}
    side = _jax_side(name, **kw)
    V = side["cfg"].vocab_size
    rng = np.random.default_rng(13)
    reqs = [([int(t) for t in rng.integers(1, V, n)], dict(max_new_tokens=4))
            for n in (40, 5)]
    seen = []
    import tmac_tpu_torch.models.llama as tl
    moe = tl.moe_mlp

    def spy(*a, valid=None, **k):
        if valid is not None:
            seen.append(int(valid.sum()))
        return moe(*a, valid=valid, **k)
    monkeypatch.setattr(tl, "moe_mlp", spy)
    kw = dict(max_batch=2, max_len=128, decode_chunk=4, prefill_chunk=64)
    jr, pr, _, peng = _both_engines(side, reqs, monkeypatch, **kw)
    assert peng.stats["prefill_chunks"] == {16: 1, 64: 1}
    if side["cfg"].num_experts:
        assert sorted(set(seen)) == [5, 40]
    _hold_to_jax(side, reqs, jr, pr, 128)
