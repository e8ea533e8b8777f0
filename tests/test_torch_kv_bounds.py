"""KV-cache writes at and past the cache's last row, against the JAX package.

JAX writes the cache with dynamic_update_slice, which clamps each slot's
start to S - T: a decode step at pos == S (a slot the engine holds at a
frozen position) rewrites row S - 1, and a prefill chunk that would run
past S ends at row S - 1.  The port clamps the same way, in its explicit
writers, in the deferred mode's one commit and in K9's store (JAX's
interpret-mode flash_decode_stacked_append_write stores at row S - 1 for
cached_lens == S), and its attention masks the rows JAX's does.

Configs as tests/test_torch_model.py's: Phi-3-mini scaled(8) with head_dim
96 and window 24 on bf16 and int8 caches, Llama-2-7B W2 scaled(8) on a bf16
cache, each with a cache of 128 rows; the gates are that file's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models import llama as jl
from tmac_tpu.ops.pallas.attention_kernel import \
    flash_decode_stacked_append_write
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.ops.cuda.attention_kernel import \
    flash_decode_append_write_plain
from tmac_tpu_torch.utils import nmse
from test_torch_model import (LOGITS_NMSE, PHI3_NMSE, _phi3_cfgs,
                              _wfp_cfgs)

torch.set_num_threads(2)

S = 128          # the cache's rows (max_len 128)
PROMPT = 8       # the prefill that fills the cache before each case
CHUNK = 16       # the chunk prefilled at pos S - 6, 10 rows past the end

_fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl", "deferred_kv"))

CONFIGS = {
    "phi3-bf16": (_phi3_cfgs, False, PHI3_NMSE),
    "phi3-int8": (_phi3_cfgs, True, PHI3_NMSE),
    "llama-bf16": (lambda: _wfp_cfgs(2), False, LOGITS_NMSE),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """The port's model and JAX's parameters, each side's cache after the
    same PROMPT-token prefill."""
    cfgs, quant, gate = CONFIGS[request.param]
    cfg, jcfg = cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    jparams = jl.init_params(jcfg, seed=0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT))
    model = Llama(cfg, params)
    cache = KVCache.create(cfg, 1, S, device="cpu", quant=quant)
    model(torch.from_numpy(prompt), cache)
    jcache = jl.KVCache.create(jcfg, 1, S, quant=quant)
    _, jcache = _fwd(jparams, jcfg, jnp.asarray(prompt), jcache, impl="pallas")
    return dict(cfg=cfg, jcfg=jcfg, params=params, jparams=jparams,
                cache=cache, jcache=jcache, quant=quant, gate=gate)


def _at(pair, pos):
    """Copies of both prefilled caches with every slot moved to pos."""
    c = pair["cache"]
    cache = KVCache(*(None if t is None else t.clone()
                      for t in (c.k, c.v, c.pos, c.k_scale, c.v_scale)))
    cache.pos.fill_(pos)
    jcache = dataclasses.replace(pair["jcache"],
                                 pos=jnp.full((1,), pos, jnp.int32))
    return cache, jcache


def _values(cache):
    """k and v as f32 numpy (L, B, KV, S, Dp), an int8 cache dequantized."""
    out = []
    for kv, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        f = kv.float()
        out.append((f if sc is None else f * sc[..., None]).numpy())
    return out


def _jax_values(jcache):
    return _values(KVCache(
        *(None if t is None else torch.from_numpy(np.array(t, np.float32))
          for t in (jcache.k, jcache.v, jcache.pos, jcache.k_scale,
                    jcache.v_scale))))


def _check(pair, logits, cache, jlogits, jcache, pos_after):
    gate = pair["gate"]
    got, want = logits[0].numpy(), np.asarray(jlogits[0])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert nmse(want, got) <= gate
    assert cache.pos.tolist() == np.asarray(jcache.pos).tolist() == [pos_after]
    for g, w in zip(_values(cache), _jax_values(jcache)):
        # the same rows written, and their values under the logits' gate
        np.testing.assert_array_equal(g.any(-1), w.any(-1))
        assert nmse(w, g) <= gate


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["explicit", "deferred"])
def test_decode_at_pos_s_matches_jax(pair, deferred):
    """One decode step at pos == S: the current row goes to row S - 1."""
    cfg = pair["cfg"]
    cache, jcache = _at(pair, S)
    before = _values(cache)
    tok = np.array([[7]])
    model = Llama(cfg, pair["params"], deferred_kv=deferred)
    logits, cache = model(torch.from_numpy(tok), cache)
    jlogits, jcache = _fwd(pair["jparams"], pair["jcfg"], jnp.asarray(tok),
                           jcache, impl="pallas", deferred_kv=deferred)
    _check(pair, logits, cache, jlogits, jcache, S + 1)
    after = _values(cache)
    for b, a in zip(before, after):
        assert a[..., S - 1, :].any() and not b[..., S - 1, :].any()
        np.testing.assert_array_equal(a[..., :S - 1, :], b[..., :S - 1, :])


def test_prefill_chunk_past_s_matches_jax(pair):
    """A chunk of CHUNK tokens at pos S - 6 lands on rows S - CHUNK .. S - 1."""
    cfg = pair["cfg"]
    cache, jcache = _at(pair, S - 6)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, CHUNK))
    logits, cache = Llama(cfg, pair["params"])(torch.from_numpy(toks), cache)
    jlogits, jcache = _fwd(pair["jparams"], pair["jcfg"], jnp.asarray(toks),
                           jcache, impl="pallas")
    _check(pair, logits, cache, jlogits, jcache, S - 6 + CHUNK)
    k = _values(cache)[0]
    assert k[..., S - CHUNK:, :].any(-1).all()
    assert not k[..., PROMPT:S - CHUNK, :].any()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_k9_store_at_cached_lens_s_matches_interpret_mode(quant):
    """JAX's flash_decode_stacked_append_write at cached_lens == S, run in
    interpret mode, stores the current row at S - 1; K9's plain version
    does the same, and attends over the same rows."""
    rng = np.random.default_rng(5)
    L, B, KV, rep, D, W = 2, 1, 2, 2, 96, 24
    if quant:
        k = rng.integers(-100, 100, (L, B, KV, S, 128)).astype(np.int8)
        v = rng.integers(-100, 100, (L, B, KV, S, 128)).astype(np.int8)
        ks = (rng.random((L, B, KV, S)) * 0.01).astype(np.float32)
        vs = (rng.random((L, B, KV, S)) * 0.01).astype(np.float32)
    else:
        k = rng.standard_normal((L, B, KV, S, 128)).astype(np.float32)
        v = rng.standard_normal((L, B, KV, S, 128)).astype(np.float32)
        ks = vs = None
    q, ck, cv = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, KV, rep, D), (B, KV, D), (B, KV, D)))
    bf = (lambda a: jnp.asarray(a, jnp.bfloat16))
    cache_j = (lambda a: jnp.asarray(a) if quant else bf(a))
    out = flash_decode_stacked_append_write(
        bf(q), cache_j(k), cache_j(v), jnp.asarray([S], jnp.int32),
        jnp.int32(1), bf(ck), bf(cv),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), window=W,
        interpret=True)
    tb = (lambda a: torch.from_numpy(a).to(torch.bfloat16))
    cache_t = (lambda a: torch.from_numpy(a.copy()) if quant else tb(a))
    kt, vt = cache_t(k), cache_t(v)
    kst = None if ks is None else torch.from_numpy(ks.copy())
    vst = None if vs is None else torch.from_numpy(vs.copy())
    got = flash_decode_append_write_plain(
        tb(q), kt, vt, torch.tensor([S], dtype=torch.int32), 1, tb(ck),
        tb(cv), k_scale=kst, v_scale=vst, window=W)
    jk = np.asarray(out[1]).astype(np.float32)
    changed = np.argwhere((jk != np.asarray(cache_j(k)).astype(np.float32)).any(-1))
    assert {tuple(r[[0, 3]]) for r in changed} == {(1, S - 1)}
    for t, j in ((kt, out[1]), (vt, out[2])):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j).astype(np.float32))
    if quant:
        for t, j in ((kst, out[3]), (vst, out[4])):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert nmse(np.asarray(out[0], np.float32), got.float().numpy()) <= 1e-5
