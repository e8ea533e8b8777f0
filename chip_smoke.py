"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          (from the repository root)

Phases, each printing one JSON line before the last two:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from tmac_tpu_torch/ops/cuda/csrc with nvcc
     (all sources in parallel), and the synthetic BitNet-3B weights;
  3. kernel K1 (fused act-quant + packed qgemm) against its plain PyTorch
     version at BitNet-3B's shapes: exact int8 codes and int32 sums on the
     call without folds, NMSE <= 1e-6 on the folded calls;
  4. kernel K2 (flash decode) against its plain version: max abs error
     <= 2e-5 in f32, within one bf16 ulp in bf16;
  5. path 1, BitNet-3B W1.58A8 at full width (26 layers, hidden 3200,
     head_dim 100), random weights from seed 0: prefill of a 16-token
     prompt and 64 greedy decode steps through the runtime's entry points,
     with the kernels' launch counts read around it (105 K1 and 26 K2
     launches per decode step); a teacher-forced check of the kernel path
     against the plain versions on the card (logits NMSE <= 1e-4,
     tie-aware argmax agreement 1.0); the eager decode rate from CUDA
     events; the same step captured in a CUDA graph (the card's own time
     per step, checked to give the eager tokens); the device time of an
     eager step by kernel from torch.profiler; each kernel's device time
     per decode step (CUDA graphs of its calls) beside its byte bound, its
     plain version and a PyTorch yardstick;
  6. path 2, Llama-2-7B W2A16 g128 at full width and depth (32 layers,
     hidden 4096, 32 heads, head_dim 128, FFN 11008, vocab 32000), random
     weights from seed 0: kernel K4 (per-group act-quant + grouped-scale
     packed qgemm) against its plain version at the path's shapes, bits 2
     and 4 (a one-layer W4A16 model), N = 1, 16 and 256 (exact codes,
     scales, code sums and per-group int32 dots without folds, NMSE
     <= 1e-6 with them), K1 on the int8 head at N = 1 and 256; prefill of
     a 256-token prompt and 64 greedy decode steps (1 K1 and 128 K4
     launches for the prefill; 128 K4, 1 K1 and 32 K2 per decode step),
     then the checks and timings of path 1, K4's at N = 1 and N = 256.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero; so does a machine without a CUDA device.
"""

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

# Published H100 / H200 peaks (NVIDIA data sheets, dense): device-memory
# bytes/s, int8 ops/s, bf16 flop/s; matched on torch's device name.
PEAKS = (("H200", 4.8e12, 1979e12, 989e12),
         ("H100 NVL", 3.9e12, 1671e12, 835e12),
         ("H100 PCIe", 2.0e12, 1513e12, 756e12),
         ("H100", 3.35e12, 1979e12, 989e12))

STEPS, FORCED, PROFILED = 64, 8, 4
BITNET_PROMPT, LLAMA_PROMPT = 16, 256
FOLDED_NMSE, K2_F32_ERR = 1e-6, 2e-5
PATH_NMSE, TIE_MARGIN = 1e-4, 1e-2


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` calls (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def capture(fn):
    """fn's device work as a CUDA graph (run once eagerly first, on a side
    stream, as capture requires)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def graph_ms(fn, reps=20):
    """Device time of fn() in ms: its CUDA graph replayed `reps` times."""
    return cuda_ms(capture(fn).replay, reps)


class Card:
    """The card, its peaks, and the random inputs of the kernel checks."""

    def __init__(self):
        import numpy as np
        import torch
        self.dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        self.smi = smi.splitlines()[0] if smi else None
        self.name = torch.cuda.get_device_name(0)
        self.bw, self.int8_peak, self.bf16_peak = next(
            (p[1:] for p in PEAKS if p[0] in self.name), PEAKS[-1][1:])
        self.rng = np.random.default_rng(1)

    def bf16(self, *shape):
        import numpy as np
        import torch
        return torch.from_numpy(self.rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).to(self.dev)

    def bound_ms(self, nbytes, ops, peak):
        return max(nbytes / self.bw, ops / peak) * 1e3


def dequant_bf16(qt):
    """The (Kp, Mp) bf16 dequantized weights of a QuantizedTensor, for the
    bf16 matmul yardstick."""
    import torch
    from tmac_tpu_torch.ops.qgemm import unpack_codes
    w = unpack_codes(qt).float()
    G = qt.scales.shape[0]
    w = w.reshape(G, -1, w.shape[-1]) * qt.scales.float()[:, None] \
        - qt.sub.float()[:, None]
    return w.reshape(qt.kdim_padded, -1).to(torch.bfloat16)


def yardstick_ms(card, x, qt, copies_for_l2):
    """bf16 x (K-padded) @ the dequantized (Kp, Mp) weights, in copies that
    together exceed the 50 MB L2 when copies_for_l2 (as the packed weights
    of a decode step do)."""
    import torch
    w = dequant_bf16(qt)
    n = 1 if not copies_for_l2 else max(1, min(4, math.ceil(120e6 / w.numel() / 2)))
    copies = [w] + [w.clone() for _ in range(n - 1)]
    xk = torch.nn.functional.pad(x[:, :qt.kdim], (0, qt.kdim_padded - qt.kdim))
    return graph_ms(lambda: [torch.matmul(xk, c) for c in copies]) / len(copies)


def qgemm_bytes(qt, x, kw):
    """Bytes one call must move: packed weights, scales and sub, x, the f32
    output, the residual and the norm weight, each once."""
    N = x.shape[0]
    return (qt.packed.numel() + 2 * qt.scales.numel() * qt.scales.element_size()
            + x.numel() * 2 + 4 * N * qt.mdim_padded
            + (2 * N * qt.mdim if kw.get("residual") is not None else 0)
            + (2 * qt.kdim if "norm" in kw else 0))


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def check_k1(card, cases):
    """K1 against its plain version; cases: (label, x, qt, folds)."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.utils import nmse
    rows, worst = [], 0.0
    for label, x, qt, kw in cases:
        N = x.shape[0]
        got = k1.qgemm_fused(x, qt, **kw)
        want = k1.qgemm_fused_plain(x, qt, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        row = dict(shape=label, N=N, max_abs_err=err,
                   bitwise=bool(torch.equal(got, want)))
        if kw:
            row["nmse"] = nmse(want.cpu().numpy(), got.cpu().numpy())
            if not row["nmse"] <= FOLDED_NMSE:
                raise AssertionError(f"K1 {label} N={N}: {row}")
        else:
            # no folds: the codes and the int32 sums are exact
            large = N >= k1.LARGE_N
            codes, xs, xsum = k1.launch_act_quant(x, qt, large_n=large)
            pc, pxs, pxsum = k1.act_quant_plain(x, qt, large_n=large)
            unit = dataclasses.replace(qt, scales=torch.ones_like(qt.scales),
                                       sub=torch.zeros_like(qt.sub))
            acc = k1.launch_gemm(codes, torch.ones_like(xs),
                                 torch.zeros_like(xsum), unit)
            want_acc = k1.int_dot_plain(pc, qt)
            row.update(codes_equal=bool(torch.equal(codes, k1.dp4a_order(pc, qt.bits))),
                       xs_equal=bool(torch.equal(xs, pxs)),
                       xsum_equal=bool(torch.equal(xsum, pxsum)),
                       acc_equal=bool(torch.equal(acc, want_acc.float())),
                       acc_absmax=int(want_acc.abs().max()))
            close = torch.allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
            if not (row["codes_equal"] and row["xs_equal"] and row["xsum_equal"]
                    and row["acc_equal"] and close):
                raise AssertionError(f"K1 {label} N={N}: {row}")
        rows.append(row)
    return rows, worst


def check_k4(card, cases):
    """K4 against its plain version; cases: (label, x, qt, folds)."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.utils import nmse
    rows, worst = [], 0.0
    for label, x, qt, kw in cases:
        N = x.shape[0]
        got = k4.qgemm_grouped(x, qt, **kw)
        want = k4.qgemm_grouped_plain(x, qt, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        row = dict(shape=label, bits=qt.bits, N=N, max_abs_err=err,
                   bitwise=bool(torch.equal(got, want)),
                   nmse=nmse(want.cpu().numpy(), got.cpu().numpy()))
        if kw:
            if not row["nmse"] <= FOLDED_NMSE:
                raise AssertionError(f"K4 {label} N={N}: {row}")
        else:
            # no folds: codes, scales, code sums and group dots are exact
            codes, xs, xsum = k4.launch_act_quant_grouped(x, qt)
            pc, pxs, pxsum = k4.act_quant_grouped_plain(x, qt)
            parts = k4.launch_group_dots(codes, qt)
            want_parts = k4.group_dots_plain(pc, qt)
            torch.cuda.synchronize()
            row.update(codes_equal=bool(torch.equal(codes, pc)),
                       xs_equal=bool(torch.equal(xs, pxs)),
                       xsum_equal=bool(torch.equal(xsum, pxsum)),
                       parts_equal=bool(torch.equal(parts, want_parts)),
                       parts_absmax=int(want_parts.abs().max()))
            if not (row["codes_equal"] and row["xs_equal"] and row["xsum_equal"]
                    and row["parts_equal"] and row["nmse"] <= FOLDED_NMSE):
                raise AssertionError(f"K4 {label} N={N}: {row}")
        rows.append(row)
    return rows, worst


def check_k2(card, Dl):
    import numpy as np
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    dev, rng = card.dev, card.rng
    S, Dp = 256, 128
    worst, rows = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for B, KV, rep, lens in ((1, 32, 1, (1,)), (1, 32, 1, (17,)),
                                 (1, 32, 1, (80,)), (1, 32, 1, (256,)),
                                 (2, 8, 4, (1, 256)), (2, 8, 4, (17, 80))):
            kc = torch.zeros((2, B, KV, S, Dp), device=dev)
            vc = torch.zeros_like(kc)
            kc[..., :Dl] = torch.from_numpy(rng.standard_normal((2, B, KV, S, Dl)).astype(np.float32)).to(dev)
            vc[..., :Dl] = torch.from_numpy(rng.standard_normal((2, B, KV, S, Dl)).astype(np.float32)).to(dev)
            q = torch.from_numpy(rng.standard_normal((B, KV, rep, Dl)).astype(np.float32)).to(dev)
            q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
            kl = torch.tensor(lens, dtype=torch.int32, device=dev)
            li = torch.tensor([1], dtype=torch.int32, device=dev)
            got = k2.flash_decode(q, kc, vc, kl, li)
            want = k2.flash_decode_plain(q, kc, vc, kl, li)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = float(diff.max()) <= K2_F32_ERR
            else:
                # one bf16 ulp of the larger of the two values; near zero,
                # where that ulp is finer than f32 sums can be held to,
                # the f32 tolerance
                mag = torch.maximum(got.float().abs(), want.float().abs())
                ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
                ok = bool((diff <= ulp.clamp_min(K2_F32_ERR)).all())
            worst = max(worst, float(diff.max()))
            rows.append(dict(dtype=str(dtype)[6:], B=B, rep=rep, lens=lens,
                             max_abs_err=float(diff.max()),
                             bitwise=bool(torch.equal(got, want))))
            if not ok:
                raise AssertionError(f"K2 check failed: {rows[-1]}")
    return rows, worst


# ---------------------------------------------------------------------------
# a main path: run, hold to the plain versions, time
# ---------------------------------------------------------------------------

COUNTERS = ("K1", "K4", "K2")


def counters():
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    return (k1.qgemm_fused, k4.qgemm_grouped, k2.flash_decode)


def read_counts():
    return dict(zip(COUNTERS, (f.launches for f in counters())))


def run_path(card, tag, cfg, params, prompt_len, want_prefill, want_step):
    """Prefill + STEPS greedy decode steps through the runtime's entry
    points, the kernels' launch counts read around it; then the
    teacher-forced check against the plain versions, the eager and graph
    step times and the profiler's breakdown.  -> (model, tokens, cache,
    launches over the run, eager step ms, graph step ms)."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.llama import KVCache, Llama
    from tmac_tpu_torch.runtime.generate import decode_loop, prefill
    from tmac_tpu_torch.runtime.sampling import sample
    from tmac_tpu_torch.utils import argmax_agreement, nmse
    dev = card.dev
    max_len = prompt_len + STEPS
    model = Llama(cfg, params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, prompt_len))
    tokens = torch.from_numpy(prompt).to(dev)
    cache = KVCache.create(cfg, 1, max_len, device=dev)
    for f in counters():
        f.launches = 0
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits)
    torch.cuda.synchronize()
    pre = read_counts()
    out, cache = decode_loop(model, first, cache, STEPS)
    torch.cuda.synchronize()
    total = read_counts()
    per_step = {k: (total[k] - pre[k]) / STEPS for k in COUNTERS}
    gen = torch.cat([first[:, None], out], 1)[0].tolist()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: prefill logits are not finite")
    if not all(0 <= t < cfg.vocab_size for t in gen) or len(gen) != STEPS + 1:
        raise AssertionError(f"{tag}: tokens out of range: {gen}")
    if pre != want_prefill or per_step != want_step:
        raise AssertionError(f"{tag}: launch counts: prefill {pre}, per step {per_step}")
    if int(cache.pos[0]) != prompt_len + STEPS:
        raise AssertionError(f"{tag}: cache pos {int(cache.pos[0])}")
    say(f"{tag}_main_path", model=cfg.name, bits=cfg.quant.bits,
        layers=cfg.num_layers, prompt=prompt_len, steps=STEPS, tokens=gen[:16],
        launches_prefill=pre, launches_per_decode_step=per_step,
        launches_total=total)

    # teacher-forced: kernel path against the plain versions on the card
    plain = Llama(cfg, params, plain=True)
    worst, agree, pairs = 0.0, [], []
    with torch.no_grad():
        caches = [KVCache.create(cfg, 1, max_len, device=dev) for _ in range(2)]
        lk, caches[0] = model(tokens, caches[0])
        lp, caches[1] = plain(tokens, caches[1])
        pairs.append((lp[0], lk[0]))
        for t in gen[:FORCED]:
            step = torch.tensor([[t]], device=dev)
            lk, caches[0] = model(step, caches[0])
            lp, caches[1] = plain(step, caches[1])
            pairs.append((lp[0], lk[0]))
    identical = all(torch.equal(ref, got) for ref, got in pairs)
    finite = all(bool(torch.isfinite(got).all()) for _, got in pairs)
    for ref, got in pairs:
        ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
        worst = max(worst, nmse(ref, got))
        agree.append(argmax_agreement(ref, got, TIE_MARGIN))
    say(f"{tag}_teacher_forced", positions=prompt_len + FORCED, max_nmse=worst,
        argmax_agreement=min(agree), bitwise=identical, finite=finite)
    if not (finite and worst <= PATH_NMSE and min(agree) == 1.0):
        raise AssertionError(f"{tag}: teacher-forced: nmse {worst}, agreement {agree}")
    del plain, caches, pairs

    # decode rate: a second run, timed with CUDA events
    cache = KVCache.create(cfg, 1, max_len, device=dev)
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    decode_loop(model, first, cache, STEPS)
    stop.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(stop) / STEPS
    say(f"{tag}_decode_rate", tokens_per_s=1e3 / step_ms, step_ms=step_ms,
        host_tokens_per_s=STEPS / host_s, card=card.name, nvidia_smi=card.smi)

    # the same step captured once in a CUDA graph and replayed: the card's
    # own time for a step, without the host's launches; it must give the
    # eager run's tokens
    cache = KVCache.create(cfg, 1, max_len, device=dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, tokens, cache)
    tok = sample(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok0, pos0 = tok.clone(), cache.pos.clone()

    def step():
        lg, _ = model(tok[:, None], cache)
        tok.copy_(sample(lg[:, -1]))
    graph = capture(step)
    tok.copy_(tok0)
    cache.pos.copy_(pos0)
    torch.cuda.synchronize()
    start.record()
    replayed = []
    for _ in range(STEPS):
        graph.replay()
        replayed.append(tok.clone())
    stop.record()
    torch.cuda.synchronize()
    graph_step_ms = start.elapsed_time(stop) / STEPS
    same = torch.cat(replayed).tolist() == gen[1:]
    say(f"{tag}_decode_graph", step_ms=graph_step_ms,
        tokens_per_s=1e3 / graph_step_ms, tokens_equal_eager=same,
        prefill_host_s=prefill_s)
    if not same:
        raise AssertionError(f"{tag}: graph-replayed decode gave other tokens")
    del graph

    # where an eager step's device time goes (torch.profiler, kernels only)
    cache = KVCache.create(cfg, 1, max_len, device=dev)
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_loop(model, first, cache, PROFILED)
        torch.cuda.synchronize()
    names = (("K4 prologue", "act_quant_grouped_kernel"),
             ("K4 dots", "group_dot_kernel"), ("K4 fold", "fold_kernel"),
             ("K1 prologue", "act_quant_kernel"), ("K1 matmul", "qgemm_kernel"),
             ("K2", "flash_decode_kernel"))
    per_step = {label: 0.0 for label, _ in names}
    per_step["torch glue"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((label for label, k in names if k in e.key), "torch glue")
        per_step[key] += e.device_time_total / 1e3 / PROFILED
    per_step = {k: v for k, v in per_step.items() if v}
    busy = sum(per_step.values())
    say(f"{tag}_device_time", ms_per_step=per_step, busy_ms=busy,
        idle_share_eager=1 - busy / step_ms,
        idle_share_graph=1 - busy / graph_step_ms)
    return model, cache, total, step_ms, graph_step_ms


def time_k2(card, cfg, cache, kv_len):
    """K2 per call over the real cache at kv_len rows: (ms, plain ms,
    bound ms, SDPA ms)."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    dev, L, Dl = card.dev, cfg.num_layers, cfg.head_dim
    kc, vc = cache.k, cache.v
    KVh, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = card.bf16(1, KVh, rep, Dl)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    lis = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    ms = graph_ms(lambda: [k2.flash_decode(q, kc, vc, kl, i) for i in lis]) / L
    plain = cuda_ms(lambda: k2.flash_decode_plain(q, kc, vc, kl, lis[1]), 3)
    qs = q.reshape(1, KVh * rep, 1, Dl)
    views = [(kc[i, :, :, :kv_len, :Dl], vc[i, :, :, :kv_len, :Dl]) for i in range(L)]
    lib = graph_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv) for kk, vv in views]) / L
    # the function needs the Dl logical columns of each valid K and V row
    # (the Dp - Dl pad columns are zeros it need not read)
    nbytes = 2 * KVh * kv_len * Dl * 2 + 2 * q.numel() * 2
    bound = card.bound_ms(nbytes, 4 * KVh * rep * kv_len * Dl, card.bf16_peak)
    return ms, plain, bound, lib


# ---------------------------------------------------------------------------
# path 1: BitNet-3B W1.58A8
# ---------------------------------------------------------------------------

def bitnet_path(card, build_s, ptxas):
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import init_params
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    cfg = get_preset("bitnet-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=card.dev)
    torch.cuda.synchronize()
    from tmac_tpu_torch.ops.cuda import build
    say("build", nvcc_s=round(build_s, 3), sources=list(build.SOURCES),
        ptxas=ptxas,
        init_params_s=round(time.perf_counter() - t0, 3))
    layers = params["layers"]
    H, I, eps = cfg.hidden_size, layers[0]["down"].kdim, cfg.rms_norm_eps
    # (weight per layer, x width, folds) at the main path's shapes
    shapes = {
        "wqkv": (lambda l: l["wqkv"], H, lambda l: dict(norm=(l["attn_norm"], eps))),
        "wo": (lambda l: l["wo"], cfg.q_dim, lambda l: dict(residual=True)),
        "gate_up": (lambda l: l["gate_up"], H, lambda l: dict(norm=(l["mlp_norm"], eps))),
        "down": (lambda l: l["down"], 2 * I, lambda l: dict(glu=True, residual=True)),
        "head": (lambda l: params["lm_head"], H, lambda l: {}),
    }

    def k1_args(shape, N, layer):
        get_w, width, folds = shapes[shape]
        qt, kw = get_w(layer), folds(layer)
        if kw.get("residual"):
            kw["residual"] = card.bf16(N, qt.mdim)
        return card.bf16(N, width), qt, kw

    cases = [(s, *k1_args(s, N, layers[0])) for s, N in (
        ("wqkv", 1), ("wqkv", 16), ("wo", 1), ("gate_up", 1), ("down", 1),
        ("down", 16), ("head", 1))]
    rows, k1_err = check_k1(card, cases)
    say("k1_check", checks=rows)
    k2_rows, k2_err = check_k2(card, cfg.head_dim)
    say("k2_check", checks=k2_rows)

    L = cfg.num_layers
    # K1: 4 linears a layer and the head; K2: one call a layer
    model, cache, launches, _, _ = run_path(
        card, "bitnet", cfg, params, BITNET_PROMPT,
        dict(K1=4 * L + 1, K4=0, K2=0),
        dict(K1=4.0 * L + 1, K4=0.0, K2=float(L)))

    # per-kernel device times at the decode shapes (N=1), each a CUDA graph
    # of its calls over the 26 layers' weights (cold in the 50 MB L2, as in
    # a decode step) replayed
    k1_rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for shape in shapes:
        calls = [k1_args(shape, 1, layers[i]) for i in range(L)]
        if shape == "head":
            calls = calls[:1]
        x, qt, kw = calls[0]
        ms = graph_ms(lambda: [k1.qgemm_fused(a, w, **f) for a, w, f in calls]
                      ) / len(calls)
        plain_ms = cuda_ms(lambda: k1.qgemm_fused_plain(x, qt, **kw), 3)
        lib_ms = yardstick_ms(card, x, qt, True)
        bound = card.bound_ms(qgemm_bytes(qt, x, kw),
                              2 * qt.kdim_padded * qt.mdim_padded, card.int8_peak)
        n = 1 if shape == "head" else L
        k1_rows.append(dict(shape=shape, K=qt.kdim_padded, Mp=qt.mdim_padded,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            library_ms=lib_ms, per_step=n))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms)):
            tot[key] += n * val
    say("k1_times", rows=k1_rows)

    kv_len = BITNET_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, cache, kv_len)
    say("k2_times", kv_len=kv_len, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound, library_ms=k2_lib, per_step=L)
    del model, cache, params
    torch.cuda.empty_cache()
    return [
        dict(name="qgemm_fused (K1)", path="bitnet-3b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K1"], max_abs_err=k1_err,
             ms=tot["ms"], plain_ms=tot["plain_ms"],
             bound_ms=tot["bound_ms"], bound_by="bytes",
             library_ms=tot["library_ms"]),
        dict(name="flash_decode (K2)", path="bitnet-3b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
             replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
             launches=launches["K2"], max_abs_err=k2_err,
             ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
             bound_by="bytes", library_ms=k2_lib * L),
    ]


# ---------------------------------------------------------------------------
# path 2: Llama-2-7B W2A16 g128
# ---------------------------------------------------------------------------

def llama_path(card):
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import init_params
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    cfg = get_preset("llama-2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=card.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg4 = dataclasses.replace(get_preset("llama-2-7b", bits=4), num_layers=1)
    params4 = init_params(cfg4, seed=0, device=card.dev)
    say("llama_build", init_params_s=round(init_s, 3), bits=2,
        layers=cfg.num_layers, w4_layers=cfg4.num_layers)
    layers = params["layers"]
    H, I, eps = cfg.hidden_size, cfg.intermediate_size, cfg.rms_norm_eps

    def k4_args(shape, N, layer, folds=True):
        """(x, qt, folds) of a linear at the main path's shapes.  down at
        bits 2 (K padded 11008 -> 11264) takes silu(g) * u computed
        before it; at bits 4 it folds the SwiGLU."""
        qt = layer[shape]
        if shape in ("wqkv", "gate_up"):
            kw = dict(norm=(layer["attn_norm" if shape == "wqkv" else "mlp_norm"], eps))
            width = H
        elif shape == "wo":
            kw, width = dict(residual=card.bf16(N, qt.mdim)), cfg.q_dim
        else:
            kw = dict(residual=card.bf16(N, qt.mdim))
            width = I
            if qt.kdim_padded == qt.kdim:
                kw["glu"], width = True, 2 * I
        return card.bf16(N, width), qt, kw if folds else {}

    shapes = ("wqkv", "wo", "gate_up", "down")
    cases = []
    for layer in (layers[0], params4["layers"][0]):
        for shape in shapes:
            for N in (1, 16, 256):
                cases.append((shape, *k4_args(shape, N, layer)))
                x, qt, _ = k4_args(shape, N, layer, folds=False)
                if shape == "down" and x.shape[1] != qt.kdim:
                    x = x[:, :qt.kdim].contiguous()
                cases.append((shape, x, qt, {}))
    rows, k4_err = check_k4(card, cases)
    say("k4_check", checks=rows)
    del cases, params4
    head = params["lm_head"]
    rows, k1_err = check_k1(card, [("head", card.bf16(N, H), head, {})
                                   for N in (1, 256)])
    say("k1_check_llama_head", checks=rows)
    k2_rows, k2_err = check_k2(card, cfg.head_dim)
    say("k2_check_llama", checks=k2_rows)

    # K4: 4 linears a layer; K1: the head; K2: one call a layer
    L = cfg.num_layers
    model, cache, launches, step_ms, graph_step_ms = run_path(
        card, "llama", cfg, params, LLAMA_PROMPT,
        dict(K1=1, K4=4 * L, K2=0), dict(K1=1.0, K4=4.0 * L, K2=float(L)))

    # K4 per call at the decode (N=1, CUDA graphs over the 32 layers'
    # weights, cold in L2) and prefill (N=256, over 4 layers' weights)
    # shapes, beside its bound, its plain version and the bf16 yardstick
    k4_rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for N, nlayers in ((1, L), (LLAMA_PROMPT, min(4, L))):
        for shape in shapes:
            calls = [k4_args(shape, N, layers[i]) for i in range(nlayers)]
            x, qt, kw = calls[0]
            ms = graph_ms(lambda: [k4.qgemm_grouped(a, w, **f) for a, w, f in calls],
                          reps=20 if N == 1 else 3) / len(calls)
            plain_ms = cuda_ms(lambda: k4.qgemm_grouped_plain(x, qt, **kw),
                               3 if N == 1 else 1)
            lib_ms = yardstick_ms(card, x, qt, N == 1)
            ops = 2 * N * qt.kdim_padded * qt.mdim_padded
            nbytes = qgemm_bytes(qt, x, kw)
            bound = card.bound_ms(nbytes, ops, card.int8_peak)
            by = "bytes" if nbytes / card.bw >= ops / card.int8_peak else "operations"
            k4_rows.append(dict(shape=shape, N=N, K=qt.kdim_padded,
                                Mp=qt.mdim_padded, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by, library_ms=lib_ms))
            if N == 1:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound), ("library_ms", lib_ms)):
                    tot[key] += L * val
    say("k4_times", rows=k4_rows, per_step=dict(tot, calls=4 * L))

    x = card.bf16(1, H)
    h_ms = graph_ms(lambda: k1.qgemm_fused(x, head))
    h_plain = cuda_ms(lambda: k1.qgemm_fused_plain(x, head), 3)
    h_lib = yardstick_ms(card, x, head, True)
    h_bound = card.bound_ms(qgemm_bytes(head, x, {}),
                            2 * head.kdim_padded * head.mdim_padded, card.int8_peak)
    say("k1_times_llama_head", ms=h_ms, plain_ms=h_plain, bound_ms=h_bound,
        library_ms=h_lib)

    kv_len = LLAMA_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, cache, kv_len)
    say("k2_times_llama", kv_len=kv_len, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound, library_ms=k2_lib, per_step=L)
    bound_step = tot["bound_ms"] + h_bound + k2_bound * L
    say("llama_step", eager_ms=step_ms, graph_ms=graph_step_ms,
        kernel_bound_ms=bound_step, card=card.name, nvidia_smi=card.smi)
    return [
        dict(name="qgemm_grouped (K4)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K4"], max_abs_err=k4_err,
             ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
             bound_by="bytes", library_ms=tot["library_ms"]),
        dict(name="qgemm_fused (K1)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K1"], max_abs_err=k1_err, ms=h_ms,
             plain_ms=h_plain, bound_ms=h_bound, bound_by="bytes",
             library_ms=h_lib),
        dict(name="flash_decode (K2)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
             replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
             launches=launches["K2"], max_abs_err=k2_err,
             ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
             bound_by="bytes", library_ms=k2_lib * L),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from tmac_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card()
    print(card.smi or "nvidia-smi: no output", flush=True)
    say("device", name=card.name, nvidia_smi=card.smi,
        count=torch.cuda.device_count(), peak_bytes_per_s=card.bw,
        peak_int8_ops=card.int8_peak, peak_bf16_flops=card.bf16_peak)

    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    # ptxas's report per kernel: registers, shared memory, spills
    ptxas, kernel = [], "?"
    for ln in "\n".join(logs.values()).splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"(act_quant_grouped|act_quant|qgemm|flash_decode"
                             r"|group_dot|fold)_kernel", mangled)
            targs = re.findall(r"Li(\d+)E", mangled)
            if "flash" in mangled:
                targs.insert(0, "bf16" if "bfloat16" in mangled else "f32")
            kernel = f"{base.group(0) if base else mangled}<{','.join(targs)}>"
        elif "registers" in ln or "spill" in ln:
            ptxas.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")

    records = bitnet_path(card, build_s, ptxas)
    records += llama_path(card)
    say("record", unit="device ms per decode step of each path (bitnet-3b: "
        "105 K1 and 26 K2 launches; llama-2-7b: 128 K4, 1 K1 and 32 K2); "
        "launches over each path's prefill + decode", card=card.name,
        nvidia_smi=card.smi)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
