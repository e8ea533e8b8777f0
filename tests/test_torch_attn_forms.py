"""Decode attention (K2, K6, K8, K9) at a cache head_dim Dp above 128 and
at more than 8 query heads per KV head, against the JAX package.

The plain versions of the four kernels at Dp 256 (Dl 256 and 200) and at
rep 12 and 16 (Dp 128 and 256) against flash_decode_stacked,
flash_decode_stacked_append and flash_decode_stacked_append_write in
interpret mode, on int8 and bf16 caches, with and without a window, each
split over split_plan's cluster size and over 1 and 3 blocks a head; K9's
whole cache after its store, exactly, also at cached length S (the row
the rep tiles' last cluster stores).  Outputs are held to 2e-5 in f32, the
tolerance of tests/test_torch_kv_modes.py.  Then a llama-2-7b scaled(8)
with head_dim 256 and 16 query heads over one KV head through the port's
decode (explicit and deferred KV writes) against JAX's forward
(impl="pallas"), and the plan's tiling (rep_tiles, ring_groups,
split_plan's tiles) against the C source's rules.  The kernels against
their plain versions on a card: tests/test_torch_attn_forms_card.py.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.attention_kernel import (
    flash_decode_stacked, flash_decode_stacked_append,
    flash_decode_stacked_append_write)
from tmac_tpu_torch.ops.cuda import attention_kernel as ak

torch.set_num_threads(2)

L, B, S, LI, BLK = 2, 3, 64, 1, 32
NSPLITS = (None, 1, 3)
# (cache head_dim, head_dim, query heads per KV head, KV heads)
FORMS = [(256, 256, 2, 2), (256, 200, 4, 1), (128, 128, 12, 1), (128, 100, 16, 1),
         (256, 256, 12, 1)]
FORM = pytest.mark.parametrize("Dp,Dl,rep,KV", FORMS,
                               ids=[f"Dp{a}-Dl{b}-rep{c}" for a, b, c, _ in FORMS])
CACHE = pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
WINDOW = pytest.mark.parametrize("window", [0, 9], ids=lambda w: f"w{w}")


def _inputs(seed, Dp, Dl, rep, KV, quant):
    """q f32 (B, KV, rep, Dl); the cache (L, B, KV, S, Dp), int8 codes with
    their f32 scales or bf16, zero past Dl; the current k/v f32 (B, KV, Dl)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, rep, Dl)).astype(np.float32)
    kv = rng.standard_normal((2, L, B, KV, S, Dl)).astype(np.float32)
    cur = rng.standard_normal((2, B, KV, Dl)).astype(np.float32)
    pad = ((0, 0),) * 5 + ((0, Dp - Dl),)
    if quant:
        sc = (np.maximum(np.abs(kv).max(-1), 1e-20) / 127.0).astype(np.float32)
        codes = np.clip(np.round(kv / sc[..., None]), -127, 127)
        return q, np.pad(codes, pad).astype(np.int8), sc, cur
    kvb = torch.from_numpy(np.pad(kv, pad)).to(torch.bfloat16).float().numpy()
    return q, kvb, None, cur


def _both(q, kv, sc, cur, quant):
    j = dict(q=jnp.asarray(q), k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]),
             ck=jnp.asarray(cur[0]), cv=jnp.asarray(cur[1]), ks=None, vs=None)
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(kv[0].copy()),
             v=torch.from_numpy(kv[1].copy()), ck=torch.from_numpy(cur[0]),
             cv=torch.from_numpy(cur[1]), ks=None, vs=None)
    if quant:
        j.update(ks=jnp.asarray(sc[0]), vs=jnp.asarray(sc[1]))
        t.update(ks=torch.from_numpy(sc[0].copy()), vs=torch.from_numpy(sc[1].copy()))
    else:
        j.update(k=j["k"].astype(jnp.bfloat16), v=j["v"].astype(jnp.bfloat16))
        t.update(k=t["k"].to(torch.bfloat16), v=t["v"].to(torch.bfloat16))
    return j, t


def _lens(window, append):
    if append:
        return (0, window - 1, S) if window else (0, 17, S - 1)
    return (1, window + 1, S) if window else (1, 40, S)


@CACHE
@WINDOW
@FORM
def test_plain_k2_k6_match_pallas(quant, window, Dp, Dl, rep, KV):
    """flash_decode (K2; K6 on an int8 cache or with a window) against
    flash_decode_stacked."""
    j, t = _both(*_inputs(Dp + Dl + rep, Dp, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, False), np.int32)
    want = np.asarray(flash_decode_stacked(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), blk=BLK,
        interpret=True, k_scale=j["ks"], v_scale=j["vs"], window=window))
    for nsplit in NSPLITS:
        got = ak.flash_decode(t["q"], t["k"], t["v"], torch.from_numpy(lens),
                              torch.tensor([LI], dtype=torch.int32), k_scale=t["ks"],
                              v_scale=t["vs"], window=window, nsplit=nsplit)
        assert got.shape == (B, KV, rep, Dl)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@CACHE
@WINDOW
@FORM
def test_plain_k8_matches_pallas(quant, window, Dp, Dl, rep, KV):
    """flash_decode_append (K8) against flash_decode_stacked_append, a fresh
    sequence among the rows."""
    j, t = _both(*_inputs(Dp + Dl + rep + 1, Dp, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, True), np.int32)
    want = np.asarray(flash_decode_stacked_append(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), j["ck"], j["cv"],
        blk=BLK, interpret=True, k_scale=j["ks"], v_scale=j["vs"], window=window))
    for nsplit in NSPLITS:
        got = ak.flash_decode_append(
            t["q"], t["k"], t["v"], torch.from_numpy(lens),
            torch.tensor([LI], dtype=torch.int32), t["ck"], t["cv"], k_scale=t["ks"],
            v_scale=t["vs"], window=window, nsplit=nsplit)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@CACHE
@WINDOW
@FORM
def test_plain_k9_matches_pallas(quant, window, Dp, Dl, rep, KV):
    """flash_decode_append_write (K9) against
    flash_decode_stacked_append_write: the output, and the whole cache after
    the store, one slot at cached length S (its store lands on row S - 1,
    inside the rows every rep tile reads)."""
    j, t = _both(*_inputs(Dp + Dl + rep + 2, Dp, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, True)[:2] + (S,), np.int32)
    res = flash_decode_stacked_append_write(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), j["ck"], j["cv"],
        blk=BLK, interpret=True, k_scale=j["ks"], v_scale=j["vs"], window=window)
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    for nsplit in NSPLITS:
        c = dict(t, **{n: t[n].clone() for n in names})
        got = ak.flash_decode_append_write(
            c["q"], c["k"], c["v"], torch.from_numpy(lens),
            torch.tensor([LI], dtype=torch.int32), c["ck"], c["cv"], k_scale=c["ks"],
            v_scale=c["vs"], window=window, nsplit=nsplit)
        np.testing.assert_allclose(got.numpy(), np.asarray(res[0]), rtol=2e-5, atol=2e-5)
        for name, want in zip(names, res[1:]):
            np.testing.assert_array_equal(c[name].float().numpy(),
                                          np.asarray(want, np.float32))
        assert not c["k"][..., Dl:].any() and not c["v"][..., Dl:].any()


def test_tiles_groups_and_plan_follow_the_kernel():
    """rep_tiles, rep_max and ring_groups are the C source's tile_rep,
    kRepMax and Ring<CT, DP>::kGroups (its constants read from the source);
    split_plan counts every tile's cluster; a rep of 8 or less at Dp 128
    keeps the earlier plan."""
    src = (Path(ak.__file__).parent / "csrc" / "flash_decode.cu").read_text()
    assert f"kRingMax = {ak.RING_MAX // 1024} * 1024" in src
    assert re.search(r"kRepMax\(int dp\) \{ return dp <= 128 \? 8 : dp <= 256 \? 4 : "
                     r"dp <= 384 \? 2 : 1; \}", src)
    assert [ak.rep_max(d) for d in ak.DPS] == [8, 4, 2, 1]
    assert [ak.rep_tiles(r, 128) for r in (1, 2, 3, 7, 8, 9, 12, 16, 17)] == \
        [1, 1, 1, 1, 1, 2, 2, 2, 3]
    assert [ak.rep_tiles(r, 256) for r in (1, 4, 5, 12, 16)] == [1, 1, 2, 3, 4]
    assert [ak.rep_tiles(r, 512) for r in (1, 2, 12)] == [1, 2, 12]
    groups = {(d, i): ak.ring_groups(d, i) for d in ak.DPS for i in (1, 2, 4)}
    assert groups == {(128, 1): 16, (128, 2): 16, (128, 4): 16,
                      (256, 1): 16, (256, 2): 16, (256, 4): 8,
                      (384, 1): 8, (384, 2): 8, (384, 4): 4,
                      (512, 1): 8, (512, 2): 8, (512, 4): 4}
    for B_, KV_ in ((1, 8), (1, 32), (8, 8)):
        assert ak.split_plan(B_, KV_, 2047) == ak.split_plan(B_, KV_, 2047, tiles=1)
    assert ak.split_plan(1, 8, 2047, tiles=2) == 8
    assert ak.split_plan(1, 8, 2047, tiles=4) == 6


def test_k9_counters_keep_every_buffer():
    """K9's counter buffers: a need past the newest makes a larger one and
    keeps the old one alive at its address (a CUDA graph captured over an
    earlier launch replays on it); a smaller need takes the newest."""
    dev = torch.device("meta")
    try:
        small = ak._done_counts(dev, 32)
        assert small.numel() == 256 and small.dtype == torch.int32
        assert ak._done_counts(dev, 200) is small
        big = ak._done_counts(dev, 4096)
        assert big.numel() == 4096 and big is not small
        assert len(ak._done[dev]) == 2 and ak._done[dev][0] is small
        assert ak._done_counts(dev, 300) is big
    finally:
        ak._done.pop(dev, None)


def test_wrapper_raises_only_where_the_reference_asserts():
    """A CUDA call is refused for Dl > Dp and a Dp that is not a multiple of
    128 (the reference's asserts), and for a Dp above 512 (no instance is
    built: the recorded limit); any rep >= 1 passes the check."""
    for Dl, Dp, msg in ((100, 96, "multiple of 128"), (200, 128, "Dl <= Dp"),
                        (100, 640, "built for")):
        with pytest.raises(ValueError, match=msg):
            ak.check_form("K2", Dl, Dp)
    for Dl, Dp in ((1, 128), (100, 128), (129, 256), (256, 256), (300, 384), (512, 512)):
        ak.check_form("K2", Dl, Dp)


def test_scaled_llama_head_dim_256_rep_16_matches_jax():
    """llama-2-7b scaled(8) with head_dim 256 and 16 query heads over one KV
    head (Dp 256, two rep tiles of 4 and, on the CPU plan, every tile's
    cluster counted): the port's prefill and greedy decode through K2's
    and K8's functions against JAX's forward(impl="pallas") teacher-forced
    on its tokens (explicit: JAX's masked XLA attention; deferred: its
    interpret-mode append kernel), within the model tests' gates."""
    import test_torch_model as tm
    from tmac_tpu.models.config import get_preset as jax_preset
    from tmac_tpu_torch.models.config import get_preset
    shape = dict(head_dim=256, num_heads=16, num_kv_heads=1)
    cfg = dataclasses.replace(get_preset("llama-2-7b").scaled(8), **shape)
    jcfg = dataclasses.replace(jax_preset("llama-2-7b").scaled(8), **shape)
    for deferred in (None, True):
        run = tm._teacher_forced(cfg, jcfg, deferred_kv=deferred)
        assert run["cache"].k.shape[-1] == 256
        tm._logits_match(run)
