"""Kernel-level profiler on the card (the port's
``tmac_tpu/tools/profile_kernels.py``).

Sweeps (M, K, N) x bits over the port's qgemm and writes a CSV of the
kernel's device time, % of the card's device-memory speed of light, and
the speedup over the bf16 dequant baseline.  The shape lists are the
reference's (x (N, K) @ W (K, M)).  ``kernel_us`` is the time of the
kernel that ``ops.qgemm.route`` takes for the row (``kernel``: K1, K3, K4,
K4L or K5) with the row's ``act`` (``qgemm_pallas``'s "auto" by default:
bf16 x quantized per group outside the kernel below the dequant dot, float
x at it; int8 x on BitNet's w_a8 tensors), glue and all.  On the card the
weights are drawn on the device (a host quantization of 11008 x 4096 costs
seconds a tensor).

    python -m tmac_tpu_torch.tools.cli profile --preset llama-2-7b --n 1 256
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

from tmac_tpu_torch.tools.timing import bench_chained, null_roundtrip

# (bits, M, K) per model family; N (batch/tokens) swept separately
SHAPE_PRESETS = {
    "llama-2-7b": [(b, M, K) for b in (2, 4) for (M, K) in
                   [(4096, 4096), (11008, 4096), (4096, 11008)]],
    "llama-2-13b": [(2, 5120, 5120), (2, 13824, 5120), (2, 5120, 13824)],
    "bitnet-3b": [(2, 3200, 8704), (2, 8704, 3200), (2, 3200, 3200)],
    "llama-3-8b": [(2, 4096, 4096), (2, 14336, 4096), (2, 4096, 14336),
                   (2, 1024, 4096)],
}

# bitnet is per-tensor W1.58A8 (its K values don't divide gs=128 anyway)
PRESET_MODE = {"bitnet-3b": "w_a8"}


def _weights(bits: int, M: int, K: int, mode: str, gs: int, device):
    """The profiled tensor, from seed 0: w_a8 ternary codes 1..3 with one
    f32 scale row 0.02 (sub twice it), as the reference's; w_fp the
    reference's from_float of N(0, 1/K) weights (zero points) on the CPU,
    and on the card codes and g-group scales drawn on the device (the
    packing's widths and value ranges, not the host draw's bytes)."""
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    if mode == "w_a8":
        gen = torch.Generator(device=device).manual_seed(0)
        wq = torch.randint(1, 4, (K, M), generator=gen, device=device, dtype=torch.uint8)
        sc = torch.full((1, M), 0.02, device=device)
        return QuantizedTensor.from_quantized(wq, sc, 2 * sc, 2, K, device=device)
    if torch.device(device).type == "cpu":
        rng = np.random.default_rng(0)
        w = (rng.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32)
        return QuantizedTensor.from_float(w, bits, gs, zero_point=True,
                                          scale_dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    G, qmax = K // gs, (1 << bits) - 1
    wq = torch.randint(0, qmax + 1, (K, M), generator=gen, device=device, dtype=torch.uint8)
    sc = (0.5 + torch.rand((G, M), generator=gen, device=device)) * (2.0 / K ** 0.5 / qmax)
    zq = torch.randint(0, qmax + 1, (G, M), generator=gen, device=device).float()
    return QuantizedTensor.from_quantized(wq, sc, sc * zq, bits, gs,
                                          scale_dtype=torch.bfloat16, device=device)


def _fold_back(out, x0):
    """The output (N, M) folded back to x's shape (N, K) and dtype, the
    chain's feedback."""
    import torch
    if out.shape[1] >= x0.shape[1]:
        fb = out[:, :x0.shape[1]]
    else:
        fb = out.repeat(1, -(-x0.shape[1] // out.shape[1]))[:, :x0.shape[1]]
    return fb.to(torch.int32).to(x0.dtype) if x0.dtype == torch.int8 else fb.to(x0.dtype)


def profile_shape(bits: int, M: int, K: int, N: int, mode: str = "w_fp",
                  gs: int = 128, iters: int = 100, overhead: float = None,
                  device=None, act: str = "auto", spec=None, min_work: float = 0.02):
    """One CSV row: the kernel's and the dequant baseline's times (µs a
    call, bench_chained), the weights' bytes at the card's rate
    (platform.device_spec) as the speed of light, and the route's kernel.
    device: "cuda" by default; "cpu" only for the tests, whose timings are
    the host's (sol_us and pct_sol are then left out).  min_work:
    bench_chained's (0: each chain keeps its `iters` calls)."""
    import torch
    from tmac_tpu_torch.ops.qgemm import dequant_baseline_matmul, qgemm, route, unpack_codes
    device = torch.device(device or "cuda")
    qt = _weights(bits, M, K, mode, gs, device)
    gen = torch.Generator(device=device).manual_seed(1)
    if mode == "w_a8":
        x0 = torch.randint(-127, 128, (N, K), generator=gen, device=device, dtype=torch.int8)
    else:
        x0 = torch.randn((N, K), generator=gen, device=device).to(torch.bfloat16)

    def step(x):
        out = qgemm(x, qt, out_dtype=torch.float32, act=act)
        return out, _fold_back(out, x0)
    t_kernel = bench_chained(step, x0, iters=iters, overhead=overhead, min_work=min_work)

    # the reference's comparator: one-byte codes dequantized to bf16 at
    # every call, then one bf16 matmul (ops.qgemm.dequant_baseline_matmul)
    w8, sc, sub = unpack_codes(qt), qt.scales, qt.sub
    xb = torch.nn.functional.pad(x0.to(torch.bfloat16), (0, qt.kdim_padded - K))

    def base(x):
        out = dequant_baseline_matmul(x, w8, sc, sub, qt.kdim_padded // sc.shape[0])
        return out, _fold_back(out, x)
    t_base = bench_chained(base, xb, iters=max(iters // 4, 10), overhead=overhead,
                           min_work=min_work)
    del w8

    wbytes = qt.packed.numel() + (qt.packed_hi.numel() if qt.packed_hi is not None else 0)
    row = {
        "bits": bits, "M": M, "K": K, "N": N, "mode": mode, "act": act,
        "kernel": route(qt, N, act=act, x_int8=x0.dtype == torch.int8),
        "kernel_us": round(t_kernel * 1e6, 2),
        "dequant_baseline_us": round(t_base * 1e6, 2),
        "speedup_vs_baseline": round(t_base / t_kernel, 2),
    }
    if device.type == "cuda":
        sol = wbytes / (spec or _spec()).hbm_bytes_per_s
        row.update(sol_us=round(sol * 1e6, 2), pct_sol=round(100 * sol / t_kernel, 1),
                   weight_GBps=round(wbytes / t_kernel / 1e9, 1))
    return row


def _spec():
    from tmac_tpu_torch.platform import device_spec
    return device_spec()


def main(argv=None):
    ap = argparse.ArgumentParser(description="qgemm kernel profiler")
    ap.add_argument("--preset", default="llama-2-7b", choices=list(SHAPE_PRESETS) + ["all"])
    ap.add_argument("--n", type=int, nargs="+", default=[1],
                    help="N values (1=decode, 256=prefill)")
    ap.add_argument("--mode", default="w_fp", choices=["w_fp", "w_a8"])
    ap.add_argument("--act", default="auto", choices=["auto", "int8", "native", "fused"],
                    help="qgemm's activation handling (w_fp presets; w_a8 takes int8 x)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--out", default="profile_results.csv")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (tests)")
    ap.add_argument("--min-work", type=float, default=0.02,
                    help="seconds a timed chain must take, lengthened until it does; 0 "
                         "keeps --iters calls (a fixed number of kernel launches)")
    args = ap.parse_args(argv)

    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("profile runs on the card: no CUDA device (--device cpu for "
                           "a host run)")
    presets = list(SHAPE_PRESETS) if args.preset == "all" else [args.preset]
    overhead = null_roundtrip()
    dev = torch.device(args.device)
    spec = _spec() if dev.type == "cuda" else None
    print(f"null round-trip {overhead * 1e3:.3f} ms; device "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu'}", file=sys.stderr)

    rows = []
    writer = None
    with open(args.out, "w", newline="") as f:
        for p in presets:
            mode = PRESET_MODE.get(p, args.mode)
            for bits, M, K in SHAPE_PRESETS[p]:
                for N in args.n:
                    try:
                        r = profile_shape(bits, M, K, N, mode=mode, iters=args.iters,
                                          overhead=overhead, device=dev,
                                          act="auto" if mode == "w_a8" else args.act,
                                          spec=spec, min_work=args.min_work)
                    except Exception as e:  # noqa: BLE001 -- keep sweeping
                        print(f"shape ({bits},{M},{K}) N={N} failed: "
                              f"{type(e).__name__}: {e}", file=sys.stderr)
                        continue
                    r["preset"] = p
                    rows.append(r)
                    print(r, file=sys.stderr)
                    # write-through: a crash or timeout must not lose the sweep
                    if writer is None:
                        writer = csv.DictWriter(f, fieldnames=list(r.keys()))
                        writer.writeheader()
                    writer.writerow(r)
                    f.flush()
    print(f"wrote {args.out} ({len(rows)} rows)", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
