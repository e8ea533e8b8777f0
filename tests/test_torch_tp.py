"""Tensor and data parallelism of the port (tmac_tpu_torch/parallel/tp.py,
launch.py; QuantizedTensor.localized; init_params(tp=); the forward's sum
over the tp group) on the CPU, against the JAX package.

The multi-process cases run as CPU ranks joined by gloo: one set of 2 and
one of 4 processes, started once for the module (each rank a Python
process that imports torch and the port only, its rendezvous a file in a
temporary directory, a hard timeout of RANK_TIMEOUT seconds), whose results
the tests read; the JAX package's make_tp_step runs meanwhile in this
process on the 8-device virtual CPU mesh (tests/conftest.py), with its
Pallas kernels in interpret mode inside shard_map (impl="pallas").

Gates: JAX's own (tests/test_parallel.py): logits within rtol 5e-2, atol
0.1 (bf16 activations, per-shard sums in another order), and the greedy
tokens the reference's argmax along them but at near-ties (a lead below
TIE, 0.2).  Against the single-device forward over the same tp-packed
weights (its k-sharded wo and down on the JAX package's XLA route, one
fold over all shards: float activations where the tp ranks' kernels
quantize them), JAX's argmax rule as its test states it, and for the
logits a noise floor in place of JAX's tolerance, which that difference
exceeds (2 of 1000 prefill logits by up to 0.04 at llama_1x2): the tp
logits no farther from the reference than FLOOR times the port's own
single-device forward over the same weights unsharded (init_params(tp=1),
every linear on its kernel's function).  The rest is exact: the packed
bytes and the meta equal JAX's, and at tp 2 the ranks' logits equal the
shard-sum reference's (the same forward in one process with each
row-parallel tensor run as its shards' kernels summed, _shard_sum)."""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.parallel import launch
from tmac_tpu_torch.parallel import tp as tpmod
from tmac_tpu_torch.utils import argmax_agreement

torch.set_num_threads(2)

RTOL, ATOL, TIE = 5e-2, 0.1, 0.2
# the noise-floor gate's factor (_jax_gate)
FLOOR = 2.0
RANK_TIMEOUT = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the decode runs: (preset, scaled, dp, tp, seed, prompt tokens, steps)
RUNS = {
    "llama_1x2": ("llama-2-7b", 4, 1, 2, 0, 4, 4),
    "llama_2x2": ("llama-2-7b", 4, 2, 2, 0, 4, 4),
    "llama_1x4": ("llama-2-7b", 4, 1, 4, 0, 4, 4),
    "bitnet_1x4": ("bitnet-3b", 8, 1, 4, 1, 3, 4),
    "mixtral_1x2": ("mixtral-8x7b", 4, 1, 2, 0, 4, 4),
}
SETS = {2: ("llama_1x2", "mixtral_1x2"), 4: ("llama_2x2", "llama_1x4", "bitnet_1x4")}
ENGINE_PROMPTS = ([1, 2, 3], [9, 8], [5, 6, 7], [4])
ENGINE_LENS = (6, 5, 4, 7)

# One rank: argv rank, world, directory.  Each run of SETS[world] at its
# mesh (the world's ranks), then the engine at tp = world (world 2) or
# dp 2 x tp 2 (world 4) and, on rank 0, the single-device references.
RANK_PROG = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[4])
    import test_torch_tp as T
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    out = T.rank_main(rank, world, d)
    if rank == 0:
        torch.save(out, d + "/out.pt")
    print("RANK_OK", rank, flush=True)
''')


def _cfg(preset, scale):
    return get_preset(preset).scaled(scale)


def _prompt(cfg, B, T, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)))


def _forced_logits(model, cache, prompt, toks):
    """Logits (B, steps, V) of the prompt's last position, then of each of
    toks[:, :-1] fed in turn (teacher-forced along toks)."""
    lg, cache = model(prompt, cache)
    out = [lg[:, -1]]
    for t in range(toks.shape[1] - 1):
        lg, cache = model(toks[:, t:t + 1], cache)
        out.append(lg[:, -1])
    return torch.stack(out, 1)


@contextlib.contextmanager
def _shard_sum():
    """Within it, models/llama.py's apply_qlinear runs a row-parallel
    tensor (k_shards > 1) as the tp ranks do, on one device: each shard
    (QuantizedTensor.k_shard) through its kernel's function on its slice of
    x (both SwiGLU halves' slices under glu), the outputs in x's dtype
    added in shard order, the residual after."""
    from tmac_tpu_torch.models import llama
    apply_qlinear = llama.apply_qlinear

    def shard_sum(x, qt, norm=None, glu=False, residual=None, plain=False, act_gs=0,
                  mode=None):
        kw = dict(plain=plain, act_gs=act_gs, mode=mode)
        if qt.k_shards == 1:
            return apply_qlinear(x, qt, norm=norm, glu=glu, residual=residual, **kw)
        ks, out = qt.kdim // qt.k_shards, None
        for s_ in range(qt.k_shards):
            xs = x[..., s_ * ks:(s_ + 1) * ks]
            if glu:
                xs = torch.cat([xs, x[..., qt.kdim + s_ * ks:qt.kdim + (s_ + 1) * ks]], -1)
            o = apply_qlinear(xs.contiguous(), qt.k_shard(s_), glu=glu, **kw)
            out = o if out is None else out + o
        return out if residual is None else residual + out

    llama.apply_qlinear = shard_sum
    try:
        yield
    finally:
        llama.apply_qlinear = apply_qlinear


def _engine_run(model, B, step_fns=None, cache=None):
    from tmac_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine(model, max_batch=B, max_len=64, decode_chunk=4,
                          step_fns=step_fns, cache=cache)
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(ENGINE_PROMPTS[:B], ENGINE_LENS)]
    res = eng.run()
    return [res[u] for u in uids]


@torch.no_grad()
def rank_main(rank, world, d):
    """What a rank runs (RANK_PROG); rank 0's results -> a dict."""
    info = launch.init("gloo", "cpu", init_method=f"file://{d}/rendezvous",
                       world_size=world, rank=rank)
    out = {"info": info}
    for name in SETS[world]:
        preset, scale, dp, tp, seed, T, steps = RUNS[name]
        cfg = _cfg(preset, scale)
        params = init_params(cfg, seed=seed, device="cpu", tp=tp)
        mesh = tpmod.make_mesh(tp=tp, dp=dp, device="cpu")
        sparams = tpmod.shard_params(params, mesh)
        prompt = _prompt(cfg, dp, T)
        prefill, decode = tpmod.make_tp_step(cfg, mesh, sparams)
        cache = tpmod.shard_cache(KVCache.create(cfg, dp, T + steps, device="cpu"), mesh)
        logits, cache = prefill(prompt, cache)
        first = torch.argmax(logits, -1).to(torch.int32)
        rest, cache = decode(first, cache, 0, steps - 1)
        toks = torch.cat([first[:, None], rest], 1)
        # the tp path's own logits along its tokens, every rank in step
        bl = prompt.shape[0] // dp
        rows = slice(mesh.dp_rank * bl, (mesh.dp_rank + 1) * bl)
        cache = tpmod.shard_cache(KVCache.create(cfg, dp, T + steps, device="cpu"), mesh)
        tf = tpmod.dp_gather(_forced_logits(prefill.model, cache, prompt[rows],
                                            toks[rows].long()).contiguous(), mesh)
        rec = {"logits": logits, "toks": toks, "tf": tf,
               "local_heads": prefill.model.cfg.num_heads}
        if rank == 0 and preset != "bitnet-3b":
            ref = Llama(cfg, params)
            rec["ref_tf"] = _forced_logits(
                ref, KVCache.create(cfg, dp, T + steps, device="cpu"), prompt, toks.long())
            with _shard_sum():
                rec["sum_tf"] = _forced_logits(
                    ref, KVCache.create(cfg, dp, T + steps, device="cpu"), prompt, toks.long())
            rec["floor_tf"] = _forced_logits(
                Llama(cfg, init_params(cfg, seed=seed, device="cpu")),
                KVCache.create(cfg, dp, T + steps, device="cpu"), prompt, toks.long())
        out[name] = rec
    # the engine: tp = world (dp 1), or dp 2 x tp 2
    cfg = _cfg("llama-2-7b", 8)
    dp, tp = (1, 2) if world == 2 else (2, 2)
    mesh = tpmod.make_mesh(tp=tp, dp=dp, device="cpu")
    params = init_params(cfg, seed=0, device="cpu", tp=tp)
    model = tpmod.tp_model(cfg, mesh, tpmod.shard_params(params, mesh))
    B = 2 * dp
    cache = tpmod.shard_cache(KVCache.create(cfg, B, 64, device="cpu"), mesh)
    out["engine"] = _engine_run(model, B, tpmod.make_engine_fns(cfg, mesh), cache)
    # the tp prefill_fn's last logits of ENGINE_PROMPTS[0] at slot 0 and at
    # the last slot (dp group dp - 1's, broadcast over dp), as JAX's test
    pf = tpmod.make_engine_fns(cfg, mesh)[0]
    toks = torch.zeros((1, 16), dtype=torch.int64)
    toks[0, :3] = torch.tensor(ENGINE_PROMPTS[0])
    out["engine_prefill"] = [
        pf(model, toks, 3, tpmod.shard_cache(KVCache.create(cfg, B, 64, device="cpu"), mesh),
           slot, 0)[0] for slot in (0, B - 1)]
    if rank == 0:
        out["engine_ref"] = _engine_run(Llama(cfg, init_params(cfg, seed=0, device="cpu")), B)
        from tmac_tpu_torch.runtime.engine import prefill_slot
        out["engine_prefill_ref"] = prefill_slot(
            Llama(cfg, params), toks, 3, KVCache.create(cfg, B, 64, device="cpu"), 0, 0)[0]
    launch.shutdown()
    return out


def _start(world, d):
    """Start `world` ranks in directory d -> their Popen handles."""
    prog = os.path.join(d, "rank.py")
    with open(prog, "w") as f:
        f.write(RANK_PROG)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen([sys.executable, prog, str(r), str(world), d, here], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _finish(procs, d):
    """Wait for the ranks (a hung or failed rank fails the test; every
    rank is killed at the timeout) -> rank 0's results."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank ran past {RANK_TIMEOUT} s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in o, f"rank {r}:\n{o[-4000:]}"
    return torch.load(os.path.join(d, "out.pt"), weights_only=False)


class _Ranks:
    """Both sets of ranks, started together; [world] waits for that set's
    results (so a test computes JAX's side while the ranks run)."""

    def __init__(self, tmp_path_factory):
        self.dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in SETS}
        self.procs = {w: _start(w, d) for w, d in self.dirs.items()}
        self.done = {}

    def __getitem__(self, world):
        if world not in self.done:
            self.done[world] = _finish(self.procs[world], self.dirs[world])
        return self.done[world]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory)
    yield r
    r.kill()


def _jax_tp(name):
    """JAX's make_tp_step on the virtual mesh, impl="pallas" (interpret
    mode inside shard_map): -> (prefill logits, tokens (B, steps))."""
    import jax
    import jax.numpy as jnp
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import KVCache as JKV
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import tp as jtp
    from tmac_tpu.runtime.sampling import SamplerConfig as JSC
    preset, scale, dp, tp, seed, T, steps = RUNS[name]
    cfg = jget(preset).scaled(scale)
    params = jinit(cfg, seed=seed, tp=tp)
    mesh = jtp.make_mesh(tp=tp, dp=dp)
    sp = jtp.shard_params(params, mesh)
    cache = jtp.shard_cache(JKV.create(cfg, dp, T + steps), mesh)
    pf, df = jtp.make_tp_step(cfg, mesh, params, JSC(), impl="pallas")
    logits, cache = pf(sp, jnp.asarray(_prompt(cfg, dp, T).numpy()), cache)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    rest, _ = df(sp, first, cache, jax.random.PRNGKey(0), steps - 1)
    return (np.asarray(logits, np.float32),
            np.concatenate([np.asarray(first)[:, None], np.asarray(rest)], 1))


def _hold_to_gates(ref, got_logits, got_toks):
    """JAX's tp gate on logits (B, steps, V) and the tokens' tie-aware
    argmax agreement along them."""
    np.testing.assert_allclose(got_logits, ref, rtol=RTOL, atol=ATOL)
    assert argmax_agreement(ref, np.eye(ref.shape[-1])[got_toks], TIE) == 1.0


def _rel_rms(a, b):
    """The mean over positions of the rms difference of logits a and b over
    b's rms."""
    return float(np.mean(np.sqrt(((a - b) ** 2).mean(-1) / (b ** 2).mean(-1))))


def _jax_gate(ref, got_logits, got_toks, floor):
    """JAX's tp gate as tests/test_parallel.py states it on the reference's
    teacher-forced logits ref (B, steps, V), its logits' tolerance replaced
    by a noise floor: the tp logits' mean relative rms difference from ref
    at most FLOOR times that of floor (another single-device forward of
    the same weights); and the tp tokens (B, steps) the reference's argmax
    at 75% of the steps at least, each other one a near-tie (the
    reference's lead over it below TIE)."""
    assert _rel_rms(got_logits, ref) <= FLOOR * _rel_rms(floor, ref), (
        _rel_rms(got_logits, ref), _rel_rms(floor, ref))
    top = ref.argmax(-1)
    assert (top == got_toks).mean() >= 0.75, (top, got_toks)
    lead = np.take_along_axis(ref, top[..., None], -1)[..., 0] - \
        np.take_along_axis(ref, got_toks[..., None], -1)[..., 0]
    assert np.all(lead[top != got_toks] < TIE), lead


# ---------------------------------------------------------------------------
# multi-process decode against JAX's make_tp_step and the single device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama_1x2", "llama_2x2", "llama_1x4", "bitnet_1x4"])
def test_tp_decode_matches_jax_make_tp_step(ranks, name):
    """The port's prefill logits within JAX's tp gate of JAX's make_tp_step
    on the same weights (per-shard activation scales in both: BitNet's
    per-tensor rows a shard), and its greedy tokens JAX's where the port's
    own logits along them lead by TIE or more."""
    jlogits, jtoks = _jax_tp(name)
    world = 2 if name in SETS[2] else 4
    rec = ranks[world][name]
    np.testing.assert_allclose(rec["logits"].numpy(), jlogits, rtol=RTOL, atol=ATOL)
    tf, toks = rec["tf"].numpy(), rec["toks"].numpy()
    np.testing.assert_allclose(tf[:, 0], jlogits, rtol=RTOL, atol=ATOL)
    # the two paths' contexts part where their tokens first do: compare up
    # to that step, where the port's lead must be a near-tie
    for b in range(toks.shape[0]):
        n = int(np.argmax(toks[b] != jtoks[b])) + 1 if (toks[b] != jtoks[b]).any() \
            else toks.shape[1]
        assert argmax_agreement(tf[b, :n], np.eye(tf.shape[-1])[jtoks[b, :n]], TIE) == 1.0


@pytest.mark.parametrize("name", ["llama_1x2", "llama_2x2", "llama_1x4", "mixtral_1x2"])
def test_tp_decode_matches_single_device(ranks, name):
    """The tp path's logits, teacher-forced along its own greedy tokens,
    within JAX's gate (_jax_gate, its noise floor the port's single-device
    forward over the same weights unsharded) of the port's single-device
    forward over the same (tp-packed) weights, whose k-sharded wo and down
    take the JAX package's XLA route (float activations, one fold over all
    shards: what JAX's forward(impl="xla") computes in its own test); and
    against
    the shard-sum reference (_shard_sum: the same forward, each
    row-parallel tensor as its shards' kernels summed) at every position
    within JAX's tolerance and tie-aware argmax, Llama at tp 2 bit for bit
    (four shards are summed in the backend's order); Mixtral's MoE MLP
    summed over the group too (the ranks' local experts on K7's function,
    the reference's k-sharded ones a shard at a time); each rank held its
    share of the heads."""
    world = 2 if name in SETS[2] else 4
    rec = ranks[world][name]
    _jax_gate(rec["ref_tf"].numpy(), rec["tf"].numpy(), rec["toks"].numpy(),
              rec["floor_tf"].numpy())
    _hold_to_gates(rec["sum_tf"].numpy(), rec["tf"].numpy(), rec["toks"].numpy())
    preset, scale, dp, tp = RUNS[name][:4]
    if tp == 2 and preset == "llama-2-7b":
        # the shard-sum reference adds two shards' bf16 outputs as the group does
        assert torch.equal(rec["tf"], rec["sum_tf"])
    assert rec["local_heads"] == _cfg(preset, scale).num_heads // tp
    assert rec["toks"].shape == (dp, RUNS[name][6])


def _jax_engine_prefill(dp, tp):
    """JAX's make_engine_fns prefill_fn on the virtual mesh (impl="pallas",
    interpret mode inside shard_map) at llama-2-7b scaled(8), init_params
    (seed 0, tp): the last logits of ENGINE_PROMPTS[0] padded to 16 at slot
    0 and at the last slot -> [(V,) f32, (V,) f32]."""
    import jax.numpy as jnp
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import KVCache as JKV
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import tp as jtp
    cfg = jget("llama-2-7b").scaled(8)
    params = jinit(cfg, seed=0, tp=tp)
    mesh = jtp.make_mesh(tp=tp, dp=dp)
    sp = jtp.shard_params(params, mesh)
    pf = jtp.make_engine_fns(cfg, mesh, impl="pallas")[0]
    toks = np.zeros((1, 16), np.int32)
    toks[0, :3] = ENGINE_PROMPTS[0]
    B = 2 * dp
    return [np.asarray(pf(sp, jnp.asarray(toks), jnp.int32(3),
                          jtp.shard_cache(JKV.create(cfg, B, 64), mesh), jnp.int32(slot),
                          jnp.int32(0))[0], np.float32) for slot in (0, B - 1)]


def _hold_engine(rec, dp, tp, first):
    """An engine run's lengths and ranges, at least `first` of its first
    tokens the single-device engine's (on the same logical weights,
    unsharded, greedy; a near-tie may flip one), and
    its prefill_fn's last logits at each probed slot (the owner's, broadcast
    over dp) against the single-device prefill_slot over the same
    tp-packed weights within JAX's engine tolerance (rtol 5e-2, atol 0.08,
    tests/test_engine.py) and against JAX's make_engine_fns prefill_fn
    within JAX's tp gate."""
    got, want = rec["engine"], rec["engine_ref"]
    cfg = _cfg("llama-2-7b", 8)
    for toks, n in zip(got, ENGINE_LENS):
        assert len(toks) == n and all(0 <= t < cfg.vocab_size for t in toks)
    assert sum(g[0] == w[0] for g, w in zip(got, want)) >= first
    ref = rec["engine_prefill_ref"].float().numpy()
    for last, jlast in zip(rec["engine_prefill"], _jax_engine_prefill(dp, tp)):
        np.testing.assert_allclose(last.numpy(), ref, rtol=5e-2, atol=0.08)
        np.testing.assert_allclose(last.numpy(), jlast, rtol=RTOL, atol=ATOL)


def test_engine_under_tp_mesh(ranks):
    """The engine on tp = 2 step functions (_hold_engine): its two
    requests' first tokens the single-device engine's."""
    _hold_engine(ranks[2], 1, 2, 2)


def test_engine_under_dp_tp_mesh(ranks):
    """dp 2 x tp 2: slots 0, 1 in dp group 0 and 2, 3 in group 1, each
    group prefilling only its own (_hold_engine: 3 of the 4 first tokens at
    least, as JAX's test; slot 3's logits come from group 1 to both)."""
    _hold_engine(ranks[4], 2, 2, 3)


@pytest.mark.parametrize("world", [2, 4])
def test_launch_init_info(ranks, world):
    """launch.init's dict, JAX's keys: rank 0 of `world` processes, one
    device each."""
    info = ranks[world]["info"]
    assert info == {"process_index": 0, "process_count": world, "local_devices": 1,
                    "global_devices": world}


# ---------------------------------------------------------------------------
# single-process: meta, bytes, specs, refusals
# ---------------------------------------------------------------------------

def _jax_tree(preset, scale, tp, seed=0):
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import init_params as jinit
    return jinit(jget(preset).scaled(scale), seed=seed, tp=tp)


def _qt_fields_equal(pq, jq):
    for f in ("bits", "group_size", "k_shards", "m_shards"):
        assert getattr(pq, f) == getattr(jq, f), f
    assert tuple(pq.shape) == tuple(jq.shape)
    assert (pq.m_segments is None) == (jq.m_segments is None)
    if pq.m_segments is not None:
        assert tuple(map(tuple, pq.m_segments)) == tuple(map(tuple, jq.m_segments))
    for f in ("packed", "packed_hi", "scales", "sub"):
        a, b = getattr(pq, f), getattr(jq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.float().numpy() if a.dtype == torch.bfloat16
                                          else a.numpy(), np.asarray(b, np.float32)
                                          if a.dtype == torch.bfloat16 else np.asarray(b))


@pytest.mark.parametrize("preset,scale,tp", [("llama-2-7b", 4, 2), ("llama-2-7b", 4, 4),
                                             ("bitnet-3b", 8, 4), ("mixtral-8x7b", 8, 2)])
def test_init_params_tp_matches_jax(preset, scale, tp):
    """init_params(tp=) byte for byte JAX's: every linear's packed bytes,
    scales, sub and meta (k-sharded wo and down, m-sharded wqkv and
    gate_up, the FFN padded for tp), and the replicated tensors."""
    jp = _jax_tree(preset, scale, tp)
    pp = init_params(_cfg(preset, scale), seed=0, device="cpu", tp=tp)
    for jl, pl in zip(jp["layers"], pp["layers"]):
        assert set(jl) == set(pl)
        for name, v in pl.items():
            if isinstance(v, QuantizedTensor):
                _qt_fields_equal(v, jl[name])
            else:
                np.testing.assert_array_equal(v.float().numpy(),
                                              np.asarray(jl[name], np.float32))
    np.testing.assert_array_equal(pp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("preset,scale,tp", [("llama-2-7b", 4, 2), ("bitnet-3b", 8, 4),
                                             ("mixtral-8x7b", 8, 2)])
def test_localized_matches_jax(preset, scale, tp, axis):
    """QuantizedTensor.localized field for field JAX's: the row-parallel
    view (k_shards 1, K / tp) of wo and down, the column-parallel one
    (m_shards 1, M / tp, each fused component's width divided) of wqkv
    and gate_up (the experts' stacks alike)."""
    jl = _jax_tree(preset, scale, tp)["layers"][0]
    pl = init_params(_cfg(preset, scale), seed=0, device="cpu", tp=tp)["layers"][0]
    names = {0: ("wo", "down", "experts_down"), 1: ("wqkv", "gate_up", "experts_gate_up")}
    for name in names[axis]:
        if name in pl:
            a, b = pl[name].localized(tp, axis), jl[name].localized(tp, axis)
            assert (a.k_shards, a.m_shards, tuple(a.shape)) == \
                (b.k_shards, b.m_shards, tuple(b.shape))
            assert (a.m_segments is None and b.m_segments is None) or \
                tuple(map(tuple, a.m_segments)) == tuple(map(tuple, b.m_segments))
            with pytest.raises(ValueError, match="shards"):
                pl[name].localized(tp, 1 - axis)


def test_params_from_numpy_carries_tp_packing():
    """JAX's tp-packed params (numpy leaves) carried into the port equal
    the port's own init_params(tp=2), meta and bytes."""
    import jax
    from tmac_tpu_torch.convert.from_jax import params_from_numpy
    cfg = _cfg("llama-2-7b", 4)
    tree = jax.tree.map(np.asarray, _jax_tree("llama-2-7b", 4, 2))
    got = params_from_numpy(tree, cfg, device="cpu")
    want = init_params(cfg, seed=0, device="cpu", tp=2)
    for gl, wl in zip(got["layers"], want["layers"]):
        for name in ("wqkv", "wo", "gate_up", "down"):
            a, b = gl[name], wl[name]
            assert (a.k_shards, a.m_shards, tuple(a.shape)) == (b.k_shards, b.m_shards,
                                                               tuple(b.shape))
            for f in ("packed", "scales", "sub"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)


def test_param_and_cache_specs_match_jax():
    """param_specs and cache_specs: JAX's PartitionSpecs as tuples."""
    from tmac_tpu.parallel import tp as jtp
    for preset, scale in (("llama-2-7b", 4), ("mixtral-8x7b", 8), ("qwen2-7b", 8)):
        jp = _jax_tree(preset, scale, 1)
        js, ps = jtp.param_specs(jp), tpmod.param_specs(
            init_params(_cfg(preset, scale), seed=0, device="cpu"))
        assert ps["embed"] == tuple(js["embed"]) == ()
        for jl, pl in zip(js["layers"], ps["layers"]):
            assert {k: tuple(v) for k, v in jl.items()} == pl
    for q in (False, True):
        jc = jtp.cache_specs(kv_quant=q)
        pc = tpmod.cache_specs(kv_quant=q)
        for f in ("k", "v", "pos", "k_scale", "v_scale"):
            j = getattr(jc, f)
            assert (None if j is None else tuple(j)) == pc[f]


def test_check_and_local_cfg_match_jax():
    """check_cfg refuses what JAX's asserts on; local_cfg is JAX's."""
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.parallel import tp as jtp
    for preset, tp in (("llama-2-7b", 2), ("llama-2-7b", 4), ("mixtral-8x7b", 2),
                       ("qwen2-7b", 2)):
        assert dataclasses.asdict(tpmod.local_cfg(get_preset(preset), tp)) == \
            dataclasses.asdict(jtp.local_cfg(jget(preset), tp))
        tpmod.check_cfg(get_preset(preset), tp)
    for preset, tp in (("qwen2-7b", 8), ("llama-2-7b", 3)):
        with pytest.raises(AssertionError):
            jtp.check_cfg(jget(preset), tp)
        with pytest.raises(ValueError):
            tpmod.check_cfg(get_preset(preset), tp)


@torch.no_grad()
def test_k_sharded_linear_on_one_device_is_the_sum_of_its_shards():
    """A row-parallel tensor (k_shards = tp) run whole on one device takes
    the JAX package's XLA route, as JAX's single-device forward runs it
    (impl="xla"; its qgemm_pallas asserts k_shards == 1): apply_qlinear
    equals JAX's apply_qlinear there (float activations at w_fp,
    activations quantized per token over the whole row at w_a8, the
    SwiGLU first, the residual in f32), one fold over every shard's
    groups, which is the sum of the shards' products, each taken alone by
    the same route (QuantizedTensor.k_shard's views equal shard_params'
    slices localized).  The kernels and their plain versions take a shard
    (k_shards 1) only; a k-sharded tensor takes no norm fold and needs
    the mode."""
    import jax
    import jax.numpy as jnp
    from tmac_tpu.models import llama as jllama
    from tmac_tpu_torch.models.llama import (apply_qlinear, quantize_activations_int8,
                                             silu_mul)
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import weights_form_error
    rng = np.random.default_rng(3)
    for preset, scale, tp, glu in (("llama-2-7b", 4, 2, False), ("llama-2-7b", 4, 2, True),
                                   ("bitnet-3b", 8, 4, True)):
        cfg = _cfg(preset, scale)
        mode = cfg.quant.mode
        down = init_params(cfg, seed=0, device="cpu", tp=tp)["layers"][0]["down"]
        jdown = _jax_tree(preset, scale, tp)["layers"][0]["down"]
        x = torch.from_numpy(rng.standard_normal((3, (2 if glu else 1) * down.kdim))
                             .astype(np.float32)).to(torch.bfloat16)
        r = torch.from_numpy(rng.standard_normal((3, down.mdim)).astype(np.float32)) \
            .to(torch.bfloat16)
        got = apply_qlinear(x, down, glu=glu, residual=r, mode=mode)
        assert got.is_contiguous()
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        if glu:
            g, u = xj[:, :down.kdim], xj[:, down.kdim:]
            xj = jax.nn.silu(g.astype(jnp.float32)).astype(g.dtype) * u
        want = jax.jit(lambda a, b: jllama.apply_qlinear(
            a, jdown, mode, impl="xla", residual=b))(
                xj, jnp.asarray(r.float().numpy()).astype(jnp.bfloat16))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)
        # the shards' products summed: the same function
        h = silu_mul(x[:, :down.kdim], x[:, down.kdim:]) if glu else x
        ks, parts = down.kdim // tp, 0.0
        for s_ in range(tp):
            sh = down.k_shard(s_)
            assert sh.k_shards == 1 and sh.kdim == ks
            xs = h[:, s_ * ks:(s_ + 1) * ks].float()
            if mode == "w_a8":
                # the row's one activation scale, as the whole-row route takes it
                q, sc = quantize_activations_int8(h)
                xs = q[:, s_ * ks:(s_ + 1) * ks].float() * sc
            parts = parts + xs @ _dequant(sh)
        np.testing.assert_allclose(got.float().numpy(), (parts + r.float()).numpy(),
                                   rtol=2e-2, atol=2e-2)
        if mode == "w_fp":
            assert "k_shards" in weights_form_error(down)
        with pytest.raises(ValueError, match="norm"):
            apply_qlinear(x, down, norm=(torch.ones(down.kdim), 1e-5), mode=mode)
        with pytest.raises(ValueError, match="mode"):
            apply_qlinear(x, down, glu=glu)


def _dequant(qt):
    """The (K, M) f32 weights of a k_shards-1 tensor (its padding cut)."""
    from tmac_tpu_torch.ops.qgemm import unpack_codes
    w = unpack_codes(qt).float()
    G = qt.scales.shape[0]
    w = w.reshape(G, -1, w.shape[-1]) * qt.scales.float()[:, None] - qt.sub.float()[:, None]
    return qt.slice_m(w.reshape(qt.kdim_padded, -1)[:qt.kdim])


@pytest.mark.parametrize("preset,scale,tp", [("llama-2-7b", 4, 2), ("llama-2-7b", 4, 4)])
def test_unsharded_tree_is_init_params_without_tp(preset, scale, tp):
    """chip_smoke.py's unsharded_tree (path 15's noise floor on the card):
    the tp-packed tree's row-parallel linears merged to k_shards 1 equal
    init_params(tp=1)'s byte for byte (the same weights: the draws do not
    depend on tp where the FFN's padded width does not)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    cfg = dataclasses.replace(_cfg(preset, scale), num_layers=1)
    got = chip_smoke.unsharded_tree(init_params(cfg, seed=0, device="cpu", tp=tp))["layers"][0]
    want = init_params(cfg, seed=0, device="cpu")["layers"][0]
    for name in ("wo", "down"):
        a, b = got[name], want[name]
        assert (a.k_shards, tuple(a.shape), a.group_size) == (b.k_shards, tuple(b.shape),
                                                              b.group_size)
        for f in ("packed", "scales", "sub"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)


def test_launch_refusals_and_one_rank():
    """No backend or device is picked for the caller: an unknown backend,
    nccl on the CPU, a CUDA device without one and a world without its
    rendezvous all raise; a world of one initializes nothing (JAX's
    single-host no-op) and its mesh has no groups."""
    with pytest.raises(ValueError, match="backend"):
        launch.init("mpi", "cpu")
    with pytest.raises(ValueError, match="nccl"):
        launch.init("nccl", "cpu")
    with pytest.raises(ValueError, match="init_method"):
        launch.init("gloo", "cpu", world_size=2, rank=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.init("gloo", "cuda:0")
    assert launch.init("gloo", "cpu") == {"process_index": 0, "process_count": 1,
                                          "local_devices": 1, "global_devices": 1}
    assert launch.device() == torch.device("cpu")
    mesh = tpmod.make_mesh(tp=1, dp=1)
    assert mesh.tp_group is None and mesh.dp_group is None and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="ranks"):
        tpmod.make_mesh(tp=2, dp=1)


def test_scaling_efficiency():
    """JAX's scaling_efficiency: 1.0 linear, below it sublinear."""
    from tmac_tpu.parallel.launch import scaling_efficiency as jeff
    for args in ((180.0, 100.0, 2), (400.0, 100.0, 4, 1), (90.0, 50.0, 4, 2)):
        assert launch.scaling_efficiency(*args) == jeff(*args)
    assert launch.scaling_efficiency(200.0, 100.0, 2) == 1.0


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_two_gloo_ranks_on_one_card(tmp_path):
    """On a card: two gloo ranks on the one device, the tp = 2 path at
    scaled(4) within JAX's gate (_jax_gate) of the single-device forward
    (chip_smoke.py --phase tp_path runs it at full width and depth)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_card_rank, args=(r, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    rec = torch.load(os.path.join(tmp_path, "card.pt"), weights_only=False)
    _jax_gate(rec["ref"], rec["tf"], rec["toks"], rec["floor"])


@torch.no_grad()
def _card_rank(rank, d):
    launch.init("gloo", "cuda:0", init_method=f"file://{d}/rendezvous", world_size=2,
                rank=rank)
    cfg = _cfg("llama-2-7b", 4)
    params = init_params(cfg, seed=0, device="cpu", tp=2)
    mesh = tpmod.make_mesh(tp=2)
    prefill, decode = tpmod.make_tp_step(cfg, mesh, tpmod.shard_params(params, mesh))
    prompt = _prompt(cfg, 1, 4).cuda()
    cache = tpmod.shard_cache(KVCache.create(cfg, 1, 8, device="cpu"), mesh)
    logits, cache = prefill(prompt, cache)
    first = torch.argmax(logits, -1).to(torch.int32)
    rest, _ = decode(first, cache, 0, 3)
    toks = torch.cat([first[:, None], rest], 1).long()
    tf = _forced_logits(prefill.model,
                        tpmod.shard_cache(KVCache.create(cfg, 1, 8, device="cpu"), mesh),
                        prompt, toks)
    if rank == 0:
        ref = Llama(cfg, {k: v for k, v in _to(params, "cuda").items()})
        want = _forced_logits(ref, KVCache.create(cfg, 1, 8, device="cuda"), prompt, toks)
        floor = _forced_logits(Llama(cfg, _to(init_params(cfg, seed=0, device="cpu"), "cuda")),
                               KVCache.create(cfg, 1, 8, device="cuda"), prompt, toks)
        torch.save({"ref": want.cpu().numpy(), "tf": tf.cpu().numpy(),
                    "floor": floor.cpu().numpy(), "toks": toks.cpu().numpy()},
                   os.path.join(d, "card.pt"))
    launch.shutdown()


def _to(tree, device):
    if isinstance(tree, QuantizedTensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)

