"""On-card autotuner (the port's ``tmac_tpu/tools/autotune.py``, the
autotvm role).

The JAX package sweeps Pallas block sizes; the port has no block_m.  What
it tunes, for each linear of a model preset at each N, is what the
kernels' plans otherwise take from their cost models
(``ops/tune_table.py``):

  * below 64 rows, the decode matmul's cluster size along K (K1 for one
    scale row, K4 for grouped scales; ``qgemm_kernel.decode_plan``);
  * from 64 rows, K3's tile and cluster size for one scale row
    (``qgemm_kernel.large_plan``), and for grouped scales the route, chunk
    (K4L) against dequant (K5) (``ops.qgemm.route``).

Each candidate runs on the card, is timed (timing.bench_chained), and is
recorded only if its output passed its parity gate against the plain
version on the same inputs: bit for bit for K1, K3, K4 and K4L, within
K5's bound (sqrt(Kp) * 2^-23 * sum |xa * W|) for K5.  The table is keyed by
the card's name.

    python -m tmac_tpu_torch.tools.cli autotune --preset llama-2-7b --n 1 256
"""

from __future__ import annotations

import argparse
import sys

from tmac_tpu_torch.ops import tune_table
from tmac_tpu_torch.tools.timing import bench_chained, null_roundtrip


def decode_candidates(N: int, Kp: int, Mp: int, bits: int, gs: int, sms: int):
    """The decode matmul's cluster sizes that fit a block at decode_plan's
    token rows: DECODE_SPLITS up to the units of the split."""
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    _, nt = k1.decode_plan(N, Kp, Mp, bits, gs, sms)
    _, unit, nunits = k1.decode_units(Kp, bits, gs)
    out = []
    for ks in k1.DECODE_SPLITS:
        if ks > nunits:
            continue
        try:
            k1.check_decode_smem("K1", N, Kp, bits, gs, ks, nt)
        except ValueError:
            continue
        out.append(ks)
    return out


def large_candidates(N: int, Kp: int, Mp: int, bits: int):
    """K3's (bm, bn, ksplit) that check_large takes, at cluster sizes 1, 2,
    4 and 8 (every tile)."""
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    out = []
    for (bm, bn) in k1.LARGE_TILES:
        for ks in (1, 2, 4, 8):
            try:
                k1.check_large(N, Kp, Mp, bits, bm, bn, ks)
            except ValueError:
                continue
            out.append((bm, bn, ks))
    return out


def _gate(kernel: str, got, want, x, qt) -> bool:
    """The parity gate: bit for bit, or (K5) within its bound."""
    import torch
    if kernel != "K5":
        return bool(torch.equal(got, want))
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as gk
    from tmac_tpu_torch.ops.qgemm import pad_x_for
    xa = pad_x_for(x.to(torch.bfloat16), qt).float()
    w = gk.dequant_weights_plain(qt).float()
    bound = qt.slice_m(xa.abs() @ w.abs()) * (qt.kdim_padded ** 0.5 * 2.0 ** -23)
    return bool(((got - want).abs() <= bound).all())


def tune_shape(bits: int, K: int, M: int, N: int, mode: str, gs: int,
               iters: int = 100, overhead: float = None, log=print,
               act: str = "fused", min_work: float = 0.005) -> dict:
    """Sweep one linear's candidates at N rows on the card and record the
    fastest that passed its parity gate.  act: "fused" (the models' form;
    bf16 x) or another act (w_a8: int8 x, the E1 route; w_fp: "auto",
    whose dispatch entries are the "float" ones).  min_work:
    bench_chained's (0: each chain keeps its `iters` calls).  -> the
    winner's row."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as gk
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.ops.cuda.attention_kernel import sm_count
    from tmac_tpu_torch.ops.qgemm import kernel_for, pad_x_for, qgemm
    from tmac_tpu_torch.tools.profile_kernels import _fold_back, _weights
    if not torch.cuda.is_available():
        raise RuntimeError("autotune runs on the card: no CUDA device")
    dev = torch.device("cuda")
    qt = _weights(bits, M, K, mode, gs, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    int8_x = mode == "w_a8" and act != "fused"
    x0 = (torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
          if int8_x else torch.randn((N, K), generator=gen, device=dev).to(torch.bfloat16))
    act = act if act == "fused" else "auto"
    grouped = qt.scales.shape[0] > 1
    Kp, Mp, gs_t = qt.kdim_padded, qt.mdim_padded, qt.group_size if grouped else 0
    plain = kernel_for(qt, N, plain=True, act=act, x_int8=int8_x)
    want = plain(x0, qt)
    sms = sm_count(dev)

    def codes_of(x):
        """The prologue a candidate's matmul runs after: the route's kernel
        for the fused form, E1's or E2's bytes for the others."""
        if grouped:
            if act == "fused":
                return gk.launch_act_quant_grouped(x, qt, kernel="K4" if N < 64 else "K4L")
            return gk.external_int8(x, qt)
        if int8_x:
            c = pad_x_for(x, qt).contiguous()
            return c, None, c.sum(1, dtype=torch.int32).float()
        return k1.launch_act_quant(x, qt, large_n=N >= 64)

    cands = []   # (label, kernel, call x -> out (N, M), recorder(us))
    if N < 64:
        kern = "K4" if grouped else "K1"
        for ks in decode_candidates(N, Kp, Mp, qt.bits, gs_t, sms):
            def call(x, ks=ks):
                codes, xs, xsum = codes_of(x)
                launch = gk.launch_decode_grouped if grouped else k1.launch_decode
                return qt.slice_m(launch(codes.contiguous(), xs, xsum, qt, ksplit=ks))
            cands.append((f"ksplit={ks}", kern, call,
                          lambda us, ks=ks: tune_table.record_decode(
                              qt.bits, Kp, Mp, N, gs_t, 0, ks, us)))
    elif not grouped:
        for bm, bn, ks in large_candidates(N, Kp, Mp, qt.bits):
            def call(x, tile=(bm, bn), ks=ks):
                codes, xs, xsum = codes_of(x)
                if int8_x:
                    codes, xs = k1.dp4a_order(codes, qt.bits).contiguous(), torch.ones_like(xsum)
                return qt.slice_m(k1.launch_large_int(codes, xs, xsum, qt, ksplit=ks, tile=tile))
            cands.append((f"tile={bm}x{bn},ksplit={ks}", "K3", call,
                          lambda us, t=(bm, bn, ks): tune_table.record_large(
                              qt.bits, Kp, Mp, N, *t, us)))
    else:
        dkey = "fused" if act == "fused" else "float"
        for disp in ("chunk", "dequant"):
            def call(x, disp=disp):
                return qgemm(x, qt, out_dtype=torch.float32, act=act, dispatch=disp)
            kern = "K4L" if disp == "chunk" else "K5"
            # each dispatch's parity is held to its own plain version
            cands.append((f"dispatch={disp}", kern, call,
                          lambda us, disp=disp: tune_table.record_dispatch(
                              qt.bits, Kp, Mp, N, qt.group_size, dkey, disp, us)))

    results = []
    for label, kern, call, record in cands:
        ref = want
        if kern in ("K4L", "K5"):
            ref = kernel_for(qt, N, plain=True, act=act,
                             dispatch="chunk" if kern == "K4L" else "dequant")(x0, qt)
        try:
            got = call(x0)
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as e:
            log(f"  {label}: refused ({type(e).__name__}: {e})")
            continue
        if not _gate(kern, got, ref, x0, qt):
            log(f"  {label}: failed its parity gate; not recorded")
            continue
        t = bench_chained(lambda x, call=call: (lambda o: (o, _fold_back(o, x0)))(call(x)),
                          x0, iters=iters, overhead=overhead, min_work=min_work)
        log(f"  {label} ({kern}): {t * 1e6:.2f} us")
        results.append((t, label, kern, record))
    if not results:
        raise RuntimeError(f"no candidate of ({K}, {M}) at N = {N} passed")
    t, label, kern, record = min(results, key=lambda r: r[0])
    if not record(t * 1e6):
        log(f"  {label}: kept the table's faster entry")
    tune_table.invalidate_cache()
    return {"bits": qt.bits, "K": K, "M": M, "N": N, "kernel": kern, "best": label,
            "us": round(t * 1e6, 2), "candidates": len(cands), "passed": len(results)}


def model_shapes(cfg):
    """The (K, M) of a layer's fused linears (models/llama.py's layout)."""
    from tmac_tpu_torch.models.llama import padded_intermediate
    H = cfg.hidden_size
    Ip = padded_intermediate(cfg, 1)
    return [(H, cfg.q_dim + 2 * cfg.kv_dim),  # wqkv
            (cfg.q_dim, H),                   # wo
            (H, 2 * Ip),                      # gate_up
            (Ip, H)]                          # down


def main(argv=None):
    from tmac_tpu_torch.models.config import PRESETS, get_preset
    ap = argparse.ArgumentParser(description="the kernels' plan autotuner")
    ap.add_argument("--preset", default="bitnet-3b", choices=list(PRESETS))
    ap.add_argument("--mode", default=None, choices=[None, "w_fp", "w_a8"])
    ap.add_argument("--n", type=int, nargs="+", default=[1])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--bits", type=int, default=None,
                    help="override the preset's weight bits (e.g. tune the "
                         "llama-2-7b W4 variant)")
    ap.add_argument("--min-work", type=float, default=0.005,
                    help="seconds a candidate's timed chain must take, lengthened until "
                         "it does; 0 keeps --iters calls (a fixed number of launches)")
    args = ap.parse_args(argv)

    cfg = get_preset(args.preset, bits=args.bits)
    mode = args.mode or cfg.quant.mode
    overhead = null_roundtrip()
    print(f"null {overhead * 1e3:.3f} ms -> {tune_table.table_path()}", file=sys.stderr)
    rows = []
    for N in args.n:
        for K, M in model_shapes(cfg):
            r = tune_shape(cfg.quant.bits, K, M, N, mode,
                           cfg.quant.group_size if cfg.quant.group_size > 0 else 128,
                           iters=args.iters, overhead=overhead, min_work=args.min_work,
                           log=lambda *a: print(*a, file=sys.stderr))
            print(r)
            rows.append(r)
    tune_table.invalidate_cache()
    return rows


if __name__ == "__main__":
    main()
