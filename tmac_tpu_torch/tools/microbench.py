"""Hardware probes on the card (the port's ``tmac_tpu/tools/microbench.py``,
the reference's blackbox/test_tbl.cc role).

The JAX package probes the TPU's HBM, MXU, VPU shift-mask unpack and a
16-entry gather to justify its design.  The same four, on the card, with
torch ops (no Pallas kernel is probed here, so none is ported):

  * hbm_rw      device-memory read + write of 1 to 64 MB (x + 1, in place
                of a copy; 1 and 8 MB stay in the 50 MB L2);
  * hbm_read    a sum over 256 MB: the read rate, printed beside the data
                sheet's (platform.device_spec);
  * mma_int8 / mma_bf16   the tensor cores' rate on an n x n x n product
                (torch._int_mm, torch.matmul), repeated in one CUDA graph;
  * shiftmask   the SWAR field extract of the packed weights (4 fields of
                2 bits a byte, int32 words): the unpack the kernels do;
  * gather      the literal T-MAC 16-entry table lookup (torch.gather),
                the road not taken.

Each time is a chain of dependent calls in one CUDA graph
(timing.bench_chained), or for the read and the products repeated calls in
one (each reads its operands anew).  On the CPU (tests only) the same probes run at
small sizes with the host's clock, and name no card.

    python -m tmac_tpu_torch.tools.cli microbench
"""

from __future__ import annotations

import argparse
import sys

from tmac_tpu_torch.tools.timing import bench_chained, null_roundtrip


def _dev(device):
    """The device a probe runs on: the card unless the caller names another
    (the tests name the CPU).  Raises without a card and no device named:
    a host rate reported as the card's would be wrong."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the probes run on the card: no CUDA device (pass "
                               "device='cpu' for a host run)")
        device = "cuda"
    return torch.device(device)


def probe_hbm_copy(overhead, sizes_mb=(1, 8, 64), device=None):
    """Read + write of an int8 buffer of each size: GB/s of both (2 bytes a
    byte), and of the read half, beside the card's data-sheet rate."""
    import torch
    dev = _dev(device)
    rows = []
    for mb in sizes_mb:
        n = mb * (1 << 20)
        x0 = torch.zeros((n // 128, 128), dtype=torch.int8, device=dev)

        def step(x):
            return x + 1, None   # read + write the full buffer, the next x
        t = bench_chained(step, x0, iters=50, overhead=overhead)
        rows.append({"probe": f"hbm_rw_{mb}MB", "GBps": round(2 * n / t / 1e9, 1),
                     "us": round(t * 1e6, 2)})
    return rows


def probe_hbm_read(mb=256, device=None, reps=10):
    """Device-memory read alone: a float32 sum over a buffer five times the
    L2 (each call reads it whole; the buffer's bytes as float32, their sum
    is not used).  GB/s read."""
    import torch
    dev = _dev(device)
    n = mb * (1 << 20)
    x = torch.ones((n // 128, 128), dtype=torch.int8, device=dev).view(torch.float32)
    out = torch.zeros((), dtype=torch.float32, device=dev)
    ms = _calls_ms(lambda: torch.sum(x, dim=(0, 1), out=out), reps, dev)
    return [{"probe": f"hbm_read_{mb}MB", "read_GBps": round(n / ms / 1e6, 1),
             "us": round(ms * 1e3, 2)}]


def _calls_ms(fn, reps, dev):
    """ms a call of fn: `reps` calls in one CUDA graph on the card (the
    card runs a stream's kernels one after another, so nothing of it is
    skipped), the host's clock on the CPU."""
    import time
    if dev.type == "cuda":
        from tmac_tpu_torch.tools.timing import graph_ms
        return graph_ms(lambda: [fn() for _ in range(reps)]) / reps
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def probe_mma(overhead, n=2048, device=None):
    """The tensor cores' rate on an n x n x n product: int8 (torch._int_mm,
    s32 sums; its second operand column-major, cuBLASLt's) and bf16
    (torch.matmul, f32 sums), repeated products of the same operands."""
    import torch
    dev = _dev(device)
    a8 = torch.ones((n, n), dtype=torch.int8, device=dev)
    b8 = torch.ones((n, n), dtype=torch.int8, device=dev).t()
    ab = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
    int_mm = (lambda: torch._int_mm(a8, b8)) if dev.type == "cuda" else \
        (lambda: a8.int() @ b8.int())
    rows = []
    for name, fn in (("int8", int_mm), ("bf16", lambda: torch.matmul(ab, ab))):
        ms = _calls_ms(fn, 20, dev)
        rows.append({"probe": f"mma_{name}_{n}", "TOPS": round(2 * n ** 3 / ms / 1e9, 1),
                     "us": round(ms * 1e3, 2)})
    return rows


def probe_shiftmask(overhead, mb=16, device=None):
    """The SWAR unpack's inner operation: 4 fields of 2 bits a byte,
    extracted from int32 words by a shift and a mask each."""
    import torch
    dev = _dev(device)
    n = mb * (1 << 20) // 4
    x0 = torch.ones((n // 128, 128), dtype=torch.int32, device=dev)

    def step(x):
        acc = x & 0x03030303
        for j in (1, 2, 3):
            acc = acc + ((x >> (2 * j)) & 0x03030303)
        return acc, None
    t = bench_chained(step, x0, iters=50, overhead=overhead)
    ops = 7 * x0.numel()  # 3 shifts + 4 ands (+ adds folded)
    return [{"probe": f"shiftmask_{mb}MB", "Gops": round(ops / t / 1e9, 1),
             "weights_per_s_G": round(16 * x0.numel() / t / 1e9, 1),
             "us": round(t * 1e6, 2)}]


def probe_gather(overhead, K=2048, M=1024, device=None):
    """The literal T-MAC lookup: lut[k, idx(k, m)], a 16-entry table a row
    of 4-bit indices (torch.gather)."""
    import torch
    dev = _dev(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    lut = torch.randint(-127, 127, (K // 4, 16), generator=gen, device=dev,
                        dtype=torch.int32)[:, None, :].expand(K // 4, M, 16)
    idx0 = torch.randint(0, 16, (K // 4, M), generator=gen, device=dev)

    def step(idx):
        vals = torch.gather(lut, 2, idx[..., None])[..., 0]
        s = vals.sum(0)  # (M,)
        return (idx + s[None, :]) & 15, None
    t = bench_chained(step, idx0, iters=20, overhead=overhead)
    return [{"probe": f"lut_gather_{K}x{M}", "lookups_per_s_G": round(idx0.numel() / t / 1e9, 2),
             "us": round(t * 1e6, 2)}]


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description="hardware probes on the card")
    ap.add_argument("--probes", nargs="+", default=["hbm", "mma", "shiftmask", "gather"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (tests)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("microbench runs on the card: no CUDA device (--device cpu for "
                           "a host run)")
    dev = torch.device(args.device)
    ov = null_roundtrip()
    small = dev.type == "cpu"   # the tests: sizes the host runs in seconds
    rows = []
    if "hbm" in args.probes:
        rows += probe_hbm_copy(ov, (1,) if small else (1, 8, 64), dev)
        rows += probe_hbm_read(1 if small else 256, dev)
        if not small:
            from tmac_tpu_torch.platform import device_spec
            spec = device_spec()
            rows[-1]["spec_GBps"] = spec.hbm_gbps
            print(f"device-memory read: {rows[-1]['read_GBps']} GB/s measured, "
                  f"{spec.hbm_gbps} GB/s on the {spec.kind} data sheet", file=sys.stderr)
    if "mma" in args.probes:
        rows += probe_mma(ov, 128 if small else 2048, dev)
    if "shiftmask" in args.probes:
        rows += probe_shiftmask(ov, 1 if small else 16, dev)
    if "gather" in args.probes:
        rows += probe_gather(ov, 256 if small else 2048, 128 if small else 1024, dev)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"device {name}, null {ov * 1e3:.3f} ms", file=sys.stderr)
    for r in rows:
        r["device"] = name
        print(r)
    return rows


if __name__ == "__main__":
    main()
