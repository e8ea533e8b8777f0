"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root)

Phases, each printing one line before the last:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from tmac_tpu_torch/ops/cuda/csrc with nvcc
     (all sources in parallel), and the synthetic BitNet-3B weights;
  3. kernel K1 (fused act-quant + packed qgemm) against its plain PyTorch
     version at the main path's shapes: exact int8 codes and int32 sums
     on the call without folds, NMSE <= 1e-6 on the folded calls;
  4. kernel K2 (flash decode) against its plain version: max abs error
     <= 2e-5 in f32, within one bf16 ulp in bf16;
  5. the main path at full width: BitNet-3B (26 layers, hidden 3200,
     head_dim 100) with random weights from seed 0, prefill of a 16-token
     prompt and 64 greedy decode steps through the runtime's entry points,
     with the kernels' launch counts read around it (105 K1 and 26 K2
     launches per decode step); a teacher-forced check of the kernel path
     against the plain versions on the card (logits NMSE <= 1e-4,
     tie-aware argmax agreement 1.0); the eager decode rate from CUDA
     events; the same step captured in a CUDA graph (the card's own time
     per step, checked to give the eager tokens); the device time of an
     eager step by kernel from torch.profiler; each kernel's device time
     per decode step (CUDA graphs of its calls) beside its byte bound, its
     plain version and a PyTorch yardstick.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero; so does a machine without a CUDA device.
"""

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

PROMPT, STEPS, FORCED, PROFILED = 16, 64, 8, 4
K1_FOLDED_NMSE, K2_F32_ERR = 1e-6, 2e-5
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    from tmac_tpu_torch.ops.cuda import build
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.ops.qgemm import unpack_codes
    from tmac_tpu_torch.runtime.generate import decode_loop, prefill
    from tmac_tpu_torch.runtime.sampling import sample
    from tmac_tpu_torch.utils import argmax_agreement, nmse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    name = torch.cuda.get_device_name(0)
    bw, int8_peak, bf16_peak = next(
        (p[1:] for p in PEAKS if p[0] in name), PEAKS[-1][1:])
    say("device", name=name, nvidia_smi=smi[0] if smi else None,
        count=torch.cuda.device_count(), peak_bytes_per_s=bw,
        peak_int8_ops=int8_peak, peak_bf16_flops=bf16_peak)

    # 2. build + weights ---------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    # ptxas's report per kernel: registers, shared memory, spills
    ptxas, kernel = [], "?"
    for ln in "\n".join(logs.values()).splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"(act_quant|qgemm|flash_decode)_kernel", mangled)
            targs = re.findall(r"Li(\d+)E", mangled)
            if "flash" in mangled:
                targs.insert(0, "bf16" if "bfloat16" in mangled else "f32")
            kernel = f"{base.group(0) if base else mangled}<{','.join(targs)}>"
        elif "registers" in ln or "spill" in ln:
            ptxas.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    cfg = get_preset("bitnet-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    say("build", nvcc_s=round(build_s, 3), sources=list(build.SOURCES),
        ptxas=ptxas, init_params_s=round(time.perf_counter() - t0, 3))
    layers = params["layers"]
    rng = np.random.default_rng(1)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16).to(dev)

    H, I = cfg.hidden_size, layers[0]["down"].kdim
    eps = cfg.rms_norm_eps
    # (name, weight per layer, x width, folds) at the main path's shapes
    shapes = {
        "wqkv": (lambda l: l["wqkv"], H, lambda l: dict(norm=(l["attn_norm"], eps))),
        "wo": (lambda l: l["wo"], cfg.q_dim, lambda l: dict(residual=True)),
        "gate_up": (lambda l: l["gate_up"], H, lambda l: dict(norm=(l["mlp_norm"], eps))),
        "down": (lambda l: l["down"], 2 * I, lambda l: dict(glu=True, residual=True)),
        "head": (lambda l: params["lm_head"], H, lambda l: {}),
    }

    def k1_args(shape, N, layer):
        get_w, width, folds = shapes[shape]
        qt = get_w(layer)
        kw = folds(layer)
        if kw.get("residual"):
            kw["residual"] = bf16(N, qt.mdim)
        return bf16(N, width), qt, kw

    # 3. K1 against its plain version -------------------------------------
    k1_err = 0.0
    checks = []
    for shape, N in (("wqkv", 1), ("wqkv", 16), ("wo", 1), ("gate_up", 1),
                     ("down", 1), ("down", 16), ("head", 1)):
        x, qt, kw = k1_args(shape, N, layers[0])
        got = k1.qgemm_fused(x, qt, **kw)
        want = k1.qgemm_fused_plain(x, qt, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k1_err = max(k1_err, err)
        row = dict(shape=shape, N=N, max_abs_err=err,
                   bitwise=bool(torch.equal(got, want)))
        if kw:
            row["nmse"] = nmse(want.cpu().numpy(), got.cpu().numpy())
            if not row["nmse"] <= K1_FOLDED_NMSE:
                raise AssertionError(f"K1 {shape} N={N}: {row}")
        else:
            # no folds: the codes and the int32 sums are exact
            codes, xs, xsum = k1.launch_act_quant(x, qt)
            pc, pxs, pxsum = k1.act_quant_plain(x, qt)
            unit = type(qt)(qt.packed, None, torch.ones_like(qt.scales),
                            torch.zeros_like(qt.sub), qt.bits, qt.group_size,
                            qt.k_shards, qt.m_shards, qt.shape)
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
                raise AssertionError(f"K1 {shape} N={N}: {row}")
        checks.append(row)
    say("k1_check", checks=checks)

    # 4. K2 against its plain version -------------------------------------
    S, Dl, Dp = 256, cfg.head_dim, 128
    k2_err, k2_rows = 0.0, []
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
            k2_err = max(k2_err, float(diff.max()))
            k2_rows.append(dict(dtype=str(dtype)[6:], B=B, rep=rep, lens=lens,
                                max_abs_err=float(diff.max()),
                                bitwise=bool(torch.equal(got, want))))
            if not ok:
                raise AssertionError(f"K2 check failed: {k2_rows[-1]}")
    say("k2_check", checks=k2_rows)

    # 5. the main path -----------------------------------------------------
    model = Llama(cfg, params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT))
    tokens = torch.from_numpy(prompt).to(dev)
    cache = KVCache.create(cfg, 1, 256, device=dev)
    k1.qgemm_fused.launches = k2.flash_decode.launches = 0
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits)
    torch.cuda.synchronize()
    pre = (k1.qgemm_fused.launches, k2.flash_decode.launches)
    out, cache = decode_loop(model, first, cache, STEPS)
    torch.cuda.synchronize()
    launches = (k1.qgemm_fused.launches, k2.flash_decode.launches)
    per_step = ((launches[0] - pre[0]) / STEPS, (launches[1] - pre[1]) / STEPS)
    gen = torch.cat([first[:, None], out], 1)[0].tolist()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    if not all(0 <= t < cfg.vocab_size for t in gen) or len(gen) != STEPS + 1:
        raise AssertionError(f"tokens out of range: {gen}")
    if pre != (105, 0) or per_step != (105.0, 26.0):
        raise AssertionError(f"launch counts: prefill {pre}, per step {per_step}")
    if int(cache.pos[0]) != PROMPT + STEPS:
        raise AssertionError(f"cache pos {int(cache.pos[0])}")
    say("main_path", model=cfg.name, layers=cfg.num_layers, prompt=PROMPT,
        steps=STEPS, tokens=gen[:16], launches_prefill=pre,
        launches_per_decode_step=per_step, launches_total=launches)

    # teacher-forced: kernel path against the plain versions on the card
    plain = Llama(cfg, params, plain=True)
    stream = gen[:FORCED]
    worst, agree = 0.0, []
    with torch.no_grad():
        caches = [KVCache.create(cfg, 1, 256, device=dev) for _ in range(2)]
        lk, caches[0] = model(tokens, caches[0])
        lp, caches[1] = plain(tokens, caches[1])
        pairs = [(lp[0], lk[0])]
        for t in stream:
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
    say("teacher_forced", positions=PROMPT + FORCED, max_nmse=worst,
        argmax_agreement=min(agree), bitwise=identical, finite=finite)
    if not (finite and worst <= PATH_NMSE and min(agree) == 1.0):
        raise AssertionError(f"teacher-forced: nmse {worst}, agreement {agree}")
    del plain, caches, pairs

    # decode rate: a second run, timed with CUDA events
    cache = KVCache.create(cfg, 1, 256, device=dev)
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
    say("decode_rate", tokens_per_s=1e3 / step_ms, step_ms=step_ms,
        host_tokens_per_s=STEPS / host_s, card=name,
        nvidia_smi=smi[0] if smi else None)

    # the same step captured once in a CUDA graph and replayed: the card's
    # own time for a step, without the host's launches; it must give the
    # eager run's tokens
    cache = KVCache.create(cfg, 1, 256, device=dev)
    logits, cache = prefill(model, tokens, cache)
    tok = sample(logits)
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
    say("decode_graph", step_ms=graph_step_ms, tokens_per_s=1e3 / graph_step_ms,
        tokens_equal_eager=same)
    if not same:
        raise AssertionError("graph-replayed decode gave other tokens")
    del graph

    # where an eager step's device time goes (torch.profiler, kernels only)
    cache = KVCache.create(cfg, 1, 256, device=dev)
    logits, cache = prefill(model, tokens, cache)
    first = sample(logits)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_loop(model, first, cache, PROFILED)
        torch.cuda.synchronize()
    per_step = {"K1 prologue": 0.0, "K1 matmul": 0.0, "K2": 0.0, "torch glue": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("K1 prologue" if "act_quant_kernel" in e.key else
               "K1 matmul" if "qgemm_kernel" in e.key else
               "K2" if "flash_decode_kernel" in e.key else "torch glue")
        per_step[key] += e.device_time_total / 1e3 / PROFILED
    busy = sum(per_step.values())
    say("device_time", ms_per_step=per_step, busy_ms=busy,
        idle_share_eager=1 - busy / step_ms,
        idle_share_graph=1 - busy / graph_step_ms)

    # per-kernel device times at the decode shapes (N=1), each a CUDA graph
    # of its calls over the 26 layers' weights (cold in the 50 MB L2, as in
    # a decode step) replayed
    L = cfg.num_layers
    k1_rows, k1_tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for shape in shapes:
        calls = [k1_args(shape, 1, layers[i]) for i in range(L)]
        if shape == "head":
            calls = calls[:1]
        x, qt, kw = calls[0]
        ms = graph_ms(lambda: [k1.qgemm_fused(a, w, **f) for a, w, f in calls]
                      ) / len(calls)
        plain_ms = cuda_ms(lambda: k1.qgemm_fused_plain(x, qt, **kw), 3)
        # yardstick: bf16 x @ the dequantized (K, Mp) weights, in copies
        # that together exceed the 50 MB L2, as the packed weights do
        w = (unpack_codes(qt).float() * qt.scales.float() - qt.sub.float()
             ).to(torch.bfloat16)
        copies = [w] + [w.clone() for _ in range(max(0, min(3, math.ceil(
            120e6 / w.numel() / 2) - 1)))]
        xk = torch.nn.functional.pad(x[:, :qt.kdim], (0, qt.kdim_padded - qt.kdim))
        lib_ms = graph_ms(lambda: [torch.matmul(xk, c) for c in copies]
                          ) / len(copies)
        del w, copies
        nbytes = (qt.packed.numel() + 8 * qt.mdim_padded + x.numel() * 2
                  + 4 * qt.mdim_padded + (2 * qt.mdim if kw.get("residual") is not None else 0)
                  + (2 * qt.kdim if "norm" in kw else 0))
        ops = 2 * qt.kdim_padded * qt.mdim_padded
        bound_ms = max(nbytes / bw, ops / int8_peak) * 1e3
        n = 1 if shape == "head" else L
        k1_rows.append(dict(shape=shape, K=qt.kdim_padded, Mp=qt.mdim_padded,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            library_ms=lib_ms, per_step=n))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms), ("library_ms", lib_ms)):
            k1_tot[key] += n * val
    say("k1_times", rows=k1_rows)

    # K2 over the real cache, at the decode steps' mean length
    kv_len = PROMPT + (1 + STEPS) // 2
    kc, vc = cache.k, cache.v
    KVh, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = bf16(1, KVh, rep, Dl)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    lis = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    k2_ms = graph_ms(lambda: [k2.flash_decode(q, kc, vc, kl, i) for i in lis]) / L
    k2_plain = cuda_ms(lambda: k2.flash_decode_plain(q, kc, vc, kl, lis[1]), 3)
    qs = q.reshape(1, KVh * rep, 1, Dl)
    views = [(kc[i, :, :, :kv_len, :Dl], vc[i, :, :, :kv_len, :Dl]) for i in range(L)]
    k2_lib = graph_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv) for kk, vv in views]) / L
    # the function needs the Dl logical columns of each valid K and V row
    # (the Dp - Dl pad columns are zeros it need not read)
    k2_bytes = 2 * KVh * kv_len * Dl * 2 + 2 * q.numel() * 2
    k2_bound = max(k2_bytes / bw, 4 * KVh * rep * kv_len * Dl / bf16_peak) * 1e3
    say("k2_times", kv_len=kv_len, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound, library_ms=k2_lib, per_step=L)

    record = {"kernels": [
        dict(name="qgemm_fused (K1)", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches[0], max_abs_err=k1_err,
             ms=k1_tot["ms"], plain_ms=k1_tot["plain_ms"],
             bound_ms=k1_tot["bound_ms"], bound_by="bytes",
             library_ms=k1_tot["library_ms"]),
        dict(name="flash_decode (K2)", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
             replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
             launches=launches[1], max_abs_err=k2_err,
             ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
             bound_by="bytes", library_ms=k2_lib * L),
    ]}
    say("record", unit="device ms per decode step (105 K1 and 26 K2 "
        "launches); launches over prefill + decode", card=name,
        nvidia_smi=smi[0] if smi else None)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
