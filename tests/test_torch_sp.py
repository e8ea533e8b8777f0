"""Sequence-parallel prefill of the port (tmac_tpu_torch/parallel/sp.py) on
the CPU, against the JAX package's make_sp_prefill and the single device.

The ranks are CPU processes joined by gloo (tests/torch_ranks.py): a set of
4 and a set of 8, started once for the module; the JAX package's sp
prefill runs meanwhile in this process on the 8-device virtual mesh
(impl="pallas": its kernels in interpret mode inside shard_map).  The
cases mirror tests/test_sp.py: sp 4 on llama-2-7b and bitnet-3b at
scaled(8) (B 2, T 16), sp 8 at a 2048-token prompt with attn_chunk 256,
sp_prefill_chunked at sp 4 (spans of 16 at start 0, 16, 32, 48), and sp x
tp at 2 x 2, 2 x 4 and 4 x 2 (llama-2-7b scaled(4), tp-packed).

Gates, JAX's own (tests/test_sp.py), rtol 3e-2 and atol 3e-2 (sp x tp: 5e-2
and 0.1): the last logits of JAX's sp prefill and of the port's single
device, which runs its prefill at the ranks' rows (chunks of T / sp, or of
span / sp) so that both take the same kernels; every layer's cache rows
within the gate of JAX's and of the single device's but where an int8
activation code flips (a recorded deviation, RSQRT_SHARE and FLIP_SHARE:
the port does not follow XLA's CPU rsqrt, ROADMAP Queue 3, and a bf16 ulp
can move a code across a tie; layer 0's rows held exactly to the single
device's).  Three runs again with XLA's rsqrt values given to the port's
norms (XLA_RSQRT): there every layer's rows are within JAX's gate of
JAX's, but at the 2048-token prompt, where a few codes flip (GIVEN_SHARE,
GIVEN_ATOL) as between JAX's own sp and single-device caches, which the
test measures.  The sp cache drives the port's single-device decode_loop
to the tokens of the single-device cache (tp 1); under sp x tp the cache
is the rank's KV heads, the one tp.make_tp_step's decode reads, and the
first greedy tokens agree with the single device at half the rows at
least (JAX's rule).  Every rank's last logits equal rank 0's."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_ranks import REPO, Ranks
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.parallel import launch
from tmac_tpu_torch.parallel import sp as spmod
from tmac_tpu_torch.parallel import tp as tpmod

torch.set_num_threads(2)

RTOL, ATOL = 3e-2, 3e-2
TP_RTOL, TP_ATOL = 5e-2, 0.1
RANK_TIMEOUT = 300
STEPS = 4
# the cache rows past layer 0 against the single device's: the share of
# them outside JAX's gate and how far (an int8 activation code on the other
# side of a tie; measured on the CPU: 0.04% by up to 0.092 at sp 4, 0.03%
# by up to 0.18 at sp x tp 2 x 2)
FLIP_SHARE, FLIP_ATOL = 2e-3, 0.25
# every layer's rows against JAX's sp cache: the share outside JAX's gate
# and how far, without XLA's rsqrt (measured: 2.7% of layer 1's rows by up
# to 0.22 at the 2048-token prompt, 2.0% by up to 0.19 in the chunked run,
# none at 16 tokens); given its values, at the 2048-token prompt (measured:
# 0.024% of layer 1's rows by up to 0.11, and JAX's own sp cache 0.031% of
# them by up to 0.125 from its single device's)
RSQRT_SHARE, RSQRT_ATOL = 3e-2, 0.25
GIVEN_SHARE, GIVEN_ATOL = 1e-3, 0.125
# (preset, scaled, seed, sp, tp, B, T, S, attn_chunk, span): span = 0 one
# prefill of T tokens, else sp_prefill_chunked in spans of that many
RUNS = {
    "llama_sp4": ("llama-2-7b", 8, 0, 4, 1, 2, 16, 32, 512, 0),
    "bitnet_sp4": ("bitnet-3b", 8, 0, 4, 1, 2, 16, 32, 512, 0),
    "chunked_sp4": ("llama-2-7b", 8, 2, 4, 1, 2, 64, 128, 64, 16),
    "sp_tp_2x2": ("llama-2-7b", 4, 3, 2, 2, 2, 16, 32, 512, 0),
    "long_sp8": ("llama-2-7b", 8, 1, 8, 1, 1, 2048, 2048, 256, 0),
    "sp_tp_2x4": ("llama-2-7b", 4, 3, 2, 4, 2, 16, 32, 512, 0),
    "sp_tp_4x2": ("llama-2-7b", 4, 3, 4, 2, 2, 16, 32, 512, 0),
}
# the runs again with XLA's rsqrt values given to the port's norms
XLA_RSQRT = {f"{n}_xla_rsqrt": n for n in ("chunked_sp4", "sp_tp_2x2", "long_sp8")}
RUNS.update({n: RUNS[base] for n, base in XLA_RSQRT.items()})
SETS = {4: ("llama_sp4", "bitnet_sp4", "chunked_sp4", "sp_tp_2x2", "chunked_sp4_xla_rsqrt",
            "sp_tp_2x2_xla_rsqrt"),
        8: ("long_sp8", "sp_tp_2x4", "sp_tp_4x2", "long_sp8_xla_rsqrt")}


def _cfg(preset, scale):
    return get_preset(preset).scaled(scale)


def _close_but_flips(got, want, rtol, atol, share=FLIP_SHARE, far=FLIP_ATOL):
    """got within rtol/atol of want but at `share` of the elements at most,
    each of those within `far` (a recorded deviation of the cache rows,
    module docstring) -> the share outside."""
    out = np.abs(got - want) > atol + rtol * np.abs(want)
    assert out.mean() <= share, out.mean()
    assert np.abs(got - want).max() <= far
    return float(out.mean())


def _tokens(cfg, seed, B, T):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)))


def _greedy(model, first, cache, steps=STEPS):
    """steps greedy tokens from first (B,) on cache (a copy)."""
    from tmac_tpu_torch.runtime.generate import decode_loop
    cache = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                                pos=cache.pos.clone())
    return decode_loop(model, first, cache, steps)[0]


@torch.no_grad()
def rank_main(rank, world, d):
    launch.init("gloo", "cpu", init_method=f"file://{d}/rendezvous", world_size=world,
                rank=rank)
    out = {}
    for name in SETS[world]:
        with pytest.MonkeyPatch.context() as mp:
            if name in XLA_RSQRT:
                import tmac_tpu_torch.models.llama as tl
                from test_torch_model_presets import given_xla_rsqrt
                given_xla_rsqrt(mp)
                mp.setattr(spmod, "rms_norm", tl.rms_norm)
            out[name] = _rank_run(name, rank, world)
    launch.shutdown()
    return out


def _rank_run(name, rank, world):
    """One run of RUNS on this rank -> its record (rank 0: the single-device
    reference and the decode tokens too, but for the XLA_RSQRT runs)."""
    preset, scale, seed, sp, tp, B, T, S, chunk, span = RUNS[name]
    cfg = _cfg(preset, scale)
    params = init_params(cfg, seed=seed, device="cpu", tp=tp)
    mesh = spmod.make_sp_tp_mesh(sp, tp, device="cpu")
    sparams = tpmod.shard_params(params, mesh) if tp > 1 else params
    prefill = spmod.make_sp_prefill(cfg, mesh, sparams, attn_chunk=chunk)
    cache = KVCache.create(cfg, B, S, device="cpu")
    cache = spmod.shard_cache_sp_tp(cache, mesh) if tp > 1 else cache
    toks = _tokens(cfg, seed, B, T)
    if span:
        last, cache = spmod.sp_prefill_chunked(prefill, toks, cache, span)
    else:
        last, cache = prefill(toks, cache)
    rec = {"last": last, "k": cache.k[:, :, :, :T].clone(), "pos": cache.pos.clone()}
    # every rank holds the last logits
    peers = [torch.zeros_like(last) for _ in range(world)]
    torch.distributed.all_gather(peers, last)
    rec["ranks_equal"] = all(torch.equal(p, last) for p in peers)
    if name in XLA_RSQRT:
        return rec
    first = torch.argmax(last, -1).to(torch.int32)
    if tp > 1:
        # the tp decode path on the same mesh reads the rank's cache
        dec = tpmod.step_fns(prefill.model, tpmod.tp_view(mesh))[1]
        rec["tp_toks"] = dec(first, cache, 0, STEPS)[0]
    if rank == 0:
        # the single device at the ranks' rows: chunks of (span or T) / sp
        ref, rc = Llama(cfg, params), KVCache.create(cfg, B, S, device="cpu")
        n = (span or T) // sp
        for off in range(0, T, n):
            rl, rc = ref(toks[:, off:off + n], rc)
        rec.update(ref_last=rl[:, -1], ref_k=rc.k[:, :, :, :T].clone())
        if tp == 1 and T <= 64:
            rec["toks_sp"] = _greedy(ref, first, cache)
            rec["toks_ref"] = _greedy(ref, torch.argmax(rl[:, -1], -1).to(torch.int32), rc)
    return rec


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks("test_torch_sp", SETS, tmp_path_factory, RANK_TIMEOUT)
    yield r
    r.kill()


def _jax_sp(name):
    """JAX's make_sp_prefill (impl="pallas") on the virtual mesh: -> (last
    logits, the cache's k rows [:T] (tp: rank 0's KV heads))."""
    return _jax_sp_run(RUNS[name])


@functools.lru_cache(maxsize=None)
def _jax_sp_run(run):
    import jax.numpy as jnp
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import KVCache as JKV
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import sp as jsp
    from tmac_tpu.parallel import tp as jtp
    preset, scale, seed, sp, tp, B, T, S, chunk, span = run
    cfg = jget(preset).scaled(scale)
    params = jinit(cfg, seed=seed, tp=tp)
    toks = jnp.asarray(_tokens(_cfg(preset, scale), seed, B, T).numpy())
    if tp > 1:
        mesh = jsp.make_sp_tp_mesh(sp, tp)
        params = jtp.shard_params(params, mesh)
        cache = jsp.shard_cache_sp_tp(JKV.create(cfg, B, S), mesh)
    else:
        mesh = jsp.make_sp_mesh(sp)
        cache = JKV.create(cfg, B, S)
    pf = jsp.make_sp_prefill(cfg, mesh, impl="pallas", attn_chunk=chunk)
    if span:
        last, cache = jsp.sp_prefill_chunked(pf, params, toks, cache, chunk=span)
    else:
        last, cache = pf(params, toks, cache)
    k = np.asarray(cache.k, np.float32)[:, :, :cfg.num_kv_heads // tp, :T]
    return np.asarray(last, np.float32), k


def _jax_single_k(name):
    """JAX's single-device prefill (impl="pallas") of a run's prompt at the
    ranks' rows (chunks of (span or T) / sp) -> the cache's k rows [:T]."""
    import jax.numpy as jnp
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import KVCache as JKV
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.runtime.generate import prefill
    preset, scale, seed, sp, tp, B, T, S, chunk, span = RUNS[name]
    cfg = jget(preset).scaled(scale)
    params = jinit(cfg, seed=seed)
    toks = jnp.asarray(_tokens(_cfg(preset, scale), seed, B, T).numpy())
    cache, n = JKV.create(cfg, B, S), (span or T) // sp
    for off in range(0, T, n):
        _, cache = prefill(params, cfg, toks[:, off:off + n], cache, impl="pallas")
    return np.asarray(cache.k, np.float32)[:, :, :, :T]


@pytest.mark.parametrize("name", ["llama_sp4", "bitnet_sp4", "chunked_sp4", "long_sp8"])
def test_sp_prefill_matches_jax_and_single_device(ranks, name):
    """sp prefill (one span, or sp_prefill_chunked's spans at start > 0):
    the last logits within JAX's gate of JAX's sp prefill and of the port's
    single-device prefill; layer 0's cached K rows within it of JAX's and
    equal to the single device's, every layer's within it of both but for
    the recorded flips (RSQRT_SHARE of JAX's, FLIP_SHARE of the single
    device's); pos = T; every rank holds the same logits; the sp cache drives decode_loop to the single
    device cache's tokens (T <= 64)."""
    preset, scale, seed, sp, tp, B, T, S, chunk, span = RUNS[name]
    rec = ranks[4 if name in SETS[4] else 8][name]
    jlast, jk = _jax_sp(name)
    last = rec["last"].numpy()
    np.testing.assert_allclose(last, jlast, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rec["k"][0].float().numpy(), jk[0], rtol=RTOL, atol=ATOL)
    _close_but_flips(rec["k"].float().numpy(), jk, RTOL, ATOL, RSQRT_SHARE, RSQRT_ATOL)
    np.testing.assert_allclose(last, rec["ref_last"].numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(rec["k"][0], rec["ref_k"][0])
    _close_but_flips(rec["k"].float().numpy(), rec["ref_k"].float().numpy(), RTOL, ATOL)
    assert (rec["pos"] == T).all() and rec["ranks_equal"]
    if "toks_sp" in rec:
        assert torch.equal(rec["toks_sp"], rec["toks_ref"])


@pytest.mark.parametrize("name", ["sp_tp_2x2", "sp_tp_2x4", "sp_tp_4x2"])
def test_sp_tp_composition(ranks, name):
    """sp x tp (tp the minor axis, tp-packed weights): the last logits and
    rank 0's KV heads of the cache within JAX's sp x tp gate of the single
    device (but for FLIP_SHARE of the rows), the last logits and layer 0's
    rows of JAX's, every layer's rows of JAX's but for RSQRT_SHARE; the
    first greedy token the single device's at half the rows at least (JAX's rule); the tp decode path reads the sp cache
    (tp.step_fns on the rank's model: finite tokens in range)."""
    preset, scale, seed, sp, tp, B, T, S, chunk, span = RUNS[name]
    rec = ranks[4 if name in SETS[4] else 8][name]
    jlast, jk = _jax_sp(name)
    last = rec["last"].numpy()
    np.testing.assert_allclose(last, jlast, rtol=TP_RTOL, atol=TP_ATOL)
    np.testing.assert_allclose(rec["k"][0].float().numpy(), jk[0], rtol=TP_RTOL, atol=TP_ATOL)
    _close_but_flips(rec["k"].float().numpy(), jk, TP_RTOL, TP_ATOL, RSQRT_SHARE, RSQRT_ATOL)
    np.testing.assert_allclose(last, rec["ref_last"].numpy(), rtol=TP_RTOL, atol=TP_ATOL)
    KVl = _cfg(preset, scale).num_kv_heads // tp
    _close_but_flips(rec["k"].float().numpy(), rec["ref_k"][:, :, :KVl].float().numpy(),
                     TP_RTOL, TP_ATOL)
    assert (last.argmax(-1) == rec["ref_last"].numpy().argmax(-1)).mean() >= 0.5
    assert (rec["pos"] == T).all() and rec["ranks_equal"]
    toks = rec["tp_toks"]
    assert toks.shape == (B, STEPS) and bool(((toks >= 0) & (toks < last.shape[-1])).all())


@pytest.mark.parametrize("name", list(XLA_RSQRT))
def test_sp_cache_every_layer_matches_jax_given_xla_rsqrt(ranks, name):
    """The ranks given XLA's rsqrt values for their norms: every layer's
    cached K rows within JAX's gate of JAX's sp cache (and the last logits),
    but at the 2048-token prompt, where GIVEN_SHARE of them may flip by up
    to GIVEN_ATOL: JAX's own sp cache flips as many as far from its
    single-device prefill at the same rows (measured here)."""
    preset, scale, seed, sp, tp, B, T, S, chunk, span = RUNS[name]
    rec = ranks[4 if name in SETS[4] else 8][name]
    jlast, jk = _jax_sp(name)
    rtol, atol = (TP_RTOL, TP_ATOL) if tp > 1 else (RTOL, ATOL)
    np.testing.assert_allclose(rec["last"].numpy(), jlast, rtol=rtol, atol=atol)
    assert (rec["pos"] == T).all() and rec["ranks_equal"]
    got = rec["k"].float().numpy()
    if T < 2048:
        np.testing.assert_allclose(got, jk, rtol=rtol, atol=atol)
        return
    _close_but_flips(got, jk, rtol, atol, GIVEN_SHARE, GIVEN_ATOL)
    own = _close_but_flips(jk, _jax_single_k(name), rtol, atol, GIVEN_SHARE, GIVEN_ATOL)
    assert own > 0, own


def test_chunked_attention_matches_jax():
    """chunked_causal_attention against JAX's _chunked_causal_attention
    (f32 off the TPU) on a cache with a cached prefix, a window and a
    chunk that must halve to divide S, within 1e-5."""
    import jax.numpy as jnp
    from tmac_tpu.parallel.sp import _chunked_causal_attention
    rng = np.random.default_rng(4)
    B, Tl, KV, rep, D, S, Dp = 2, 8, 2, 3, 64, 96, 128
    q = rng.standard_normal((B, Tl, KV, rep, D)).astype(np.float32)
    k = np.zeros((B, KV, S, Dp), np.float32)
    v = np.zeros((B, KV, S, Dp), np.float32)
    k[..., :D] = rng.standard_normal((B, KV, S, D))
    v[..., :D] = rng.standard_normal((B, KV, S, D))
    pos = np.broadcast_to(40 + np.arange(Tl, dtype=np.int32), (B, Tl))
    for window, chunk in ((0, 64), (17, 40), (0, 512)):
        want = _chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos), 48, D, chunk, window)
        got = spmod.chunked_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), torch.from_numpy(pos.copy()),
                                             48, D, chunk, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sp_refuses_what_jax_asserts():
    """MoE configs, a prompt that sp does not divide, a chunk that does not
    divide the prompt, and an int8 cache are refused."""
    mesh = tpmod.Mesh(dp=1, tp=1, rank=0, device=torch.device("cpu"))
    moe = _cfg("mixtral-8x7b", 8)
    with pytest.raises(ValueError, match="MoE"):
        spmod.make_sp_prefill(moe, mesh, None)
    cfg = _cfg("llama-2-7b", 8)
    two = tpmod.Mesh(dp=2, tp=1, rank=0, device=torch.device("cpu"))
    pf = spmod.make_sp_prefill(cfg, two, init_params(cfg, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        pf(torch.zeros((1, 5), dtype=torch.int64), KVCache.create(cfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        spmod.sp_prefill_chunked(pf, torch.zeros((1, 10), dtype=torch.int64), None, 4)
    with pytest.raises(ValueError, match="int8"):
        spmod.shard_cache_sp_tp(KVCache.create(cfg, 1, 8, device="cpu", quant=True), mesh)


def test_sp_pp_noise_floor_gate():
    """chip_smoke.py's gate of sp and pp against the single device
    (single_gate: JAX's tolerance, or the noise floor of another
    single-device route), on the CPU at 8 layers of llama-2-7b scaled(8), a
    384-token prompt: sp 2 in one process (sp_one_process, what the ranks
    compute; bit for bit to them on the card) against the single device at
    the ranks' rows (192-row chunks, K4L; the floor: one 384-row chunk,
    K5), and pp 2 (pp_one_process, 128-row microbatches) likewise, each
    over 4 greedy steps.  Measured: JAX's gate fails at 8 layers (sp
    0.065, pp 0.072 off at most), the floor holds (relative rms 0.049
    against 0.105, 0.037 against 0.081): the recorded deviation."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cfg = dataclasses.replace(_cfg("llama-2-7b", 8), num_layers=8)
    params = init_params(cfg, seed=5, device="cpu")
    single = Llama(cfg, params)
    dev = torch.device("cpu")
    prompt = _tokens(cfg, 5, 1, 384)
    last, _ = cs.sp_one_process(single, prompt, KVCache.create(cfg, 1, 384, device="cpu"), 2)
    toks = torch.argmax(last, -1)[None]
    want = cs.forced_logits(single, cfg, prompt, toks, dev, chunk=192).numpy()
    floor = cs.forced_logits(single, cfg, prompt, toks, dev).numpy()
    gate = cs.single_gate(want, last.numpy(), floor, RTOL, ATOL)
    assert gate["held"], gate
    logits, _ = cs.pp_one_process(cfg, params, prompt, 128, 4, dev)
    toks = logits.argmax(-1)[None]
    want = cs.forced_logits(single, cfg, prompt, toks, dev, chunk=128).numpy()
    floor = cs.forced_logits(single, cfg, prompt, toks, dev).numpy()
    gate = cs.single_gate(want, logits.numpy(), floor, RTOL, ATOL)
    assert gate["held"], gate
