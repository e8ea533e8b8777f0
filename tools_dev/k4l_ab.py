"""K4L (group_mma_kernel) per call at the model paths' shapes, on one
card, for an A/B of two packages or of variants of the kernel's source.

    python tools_dev/k4l_ab.py new                 # this checkout's package
    python tools_dev/k4l_ab.py parent DIR          # the package under DIR
    python tools_dev/k4l_ab.py variants [NAME...]  # VARIANTS of this source

Each mode prints one JSON line: per shape the ms a call (4 weight copies
rotated in a CUDA graph, so the weights are cold in L2), and whether the
output equals the plain version bit for bit.  `variants` patches
csrc/qgemm_grouped_large.cu textually, builds each patched copy with the
package's nvcc flags into _scratch/k4l_variants/ and times it through the
package's own wrapper (a variant holds the bf16-scale instances, as the
source builds by default: its f32 shapes raise).  Some variants compute wrong results on purpose (a
part of the kernel left out, to time what it costs); the bitwise column
says which.  Run parent, new (or variants), then parent again on one card:
a card's power limit moves absolute times between machines.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, K, M, bits, gs, ags, N): the K4L shapes of chip_smoke.py's paths
SHAPES = [("phi3 wqkv", 3072, 9216, 2, 128, 0, 256),
          ("qwen down", 18944, 3584, 4, 128, 0, 256),
          ("l7 ags wqkv", 4096, 12288, 2, 128, 32, 256),
          ("l7 ags down", 11264, 4096, 2, 128, 32, 256),
          ("l3 down", 14336, 4096, 3, 128, 0, 256),
          ("gs32 down", 14336, 4096, 4, 32, 0, 88),
          ("gs32 k4160", 4160, 4096, 4, 32, 0, 88)]  # 130 groups: a last block of 2

# the fold's factors of unit g (g >= 2) read into registers once its
# first step's barrier has passed, before that step's products
PREFETCH = [
    ("  auto step = [&](int t) {\n    cp_async_wait<kLStages - 2>();\n    __syncthreads();\n"
     "    if (t + kLStages - 1 < ntiles) load(t + kLStages - 1, (t + kLStages - 1) % kLStages);\n"
     "    cp_async_commit();\n",
     "  auto step = [&](int t, auto&& before) {\n    cp_async_wait<kLStages - 2>();\n"
     "    __syncthreads();\n"
     "    if (t + kLStages - 1 < ntiles) load(t + kLStages - 1, (t + kLStages - 1) % kLStages);\n"
     "    cp_async_commit();\n    before();\n"),
    ("  for (; t < steps_g; ++t) step(t);\n", "  for (; t < steps_g; ++t) step(t, [] {});\n"),
    ("  for (; t < 2 * steps_g; ++t) step(t);\n",
     "  for (; t < 2 * steps_g; ++t) step(t, [] {});\n"),
    ("    for (int i = 0; i < steps_g; ++i, ++t) step(t);\n    float xr[4][2], sc[4][2];\n"
     "#pragma unroll\n    for (int mt = 0; mt < 4; ++mt)\n#pragma unroll\n"
     "      for (int h = 0; h < 2; ++h) xr[mt][h] = row_f(g, mt, h);\n#pragma unroll\n"
     "    for (int c = 0; c < 4; ++c)\n#pragma unroll\n"
     "      for (int e = 0; e < 2; ++e) sc[c][e] = col_f(g, c, e);\n",
     "    float xr[4][2], sc[4][2];\n    step(t++, [&] {\n#pragma unroll\n"
     "      for (int mt = 0; mt < 4; ++mt)\n#pragma unroll\n"
     "        for (int h = 0; h < 2; ++h) xr[mt][h] = row_f(g, mt, h);\n#pragma unroll\n"
     "      for (int c = 0; c < 4; ++c)\n#pragma unroll\n"
     "        for (int e = 0; e < 2; ++e) sc[c][e] = col_f(g, c, e);\n    });\n"
     "    for (int i = 1; i < steps_g; ++i, ++t) step(t, [] {});\n")]
FU4 = [("  const int fu = Gf % 4 == 0 ? 4 : 2, fu_shift = fu == 4 ? 2 : 1;\n",
        "  constexpr int fu = 4, fu_shift = 2;\n")]

# name -> [(old, new)] applied to qgemm_grouped_large.cu
VARIANTS = {
    "stream": [],
    # the factor blocks' copies left out: the fold reads stale slots
    "no_factor_copies": [(
        "    uint8_t* blk = fac + (b % kBlockSlots) * kBlock;\n",
        "    if (b >= 0) return;\n    uint8_t* blk = fac + (b % kBlockSlots) * kBlock;\n")],
    # the block's fold units fixed at 4 (right where Gf % 4 == 0)
    # no factor block is loaded, nor its step tested for: the fold reads
    # stale slots
    "no_factor_step": [(
        "    if (t == fac_next) {\n      load_factors(fac_block++);\n      fac_next += steps_b;\n    }\n",
        "")],
    # the steady loop's fold with constant factors (no shared memory reads)
    "fold_const": [(
        "      for (int h = 0; h < 2; ++h) xr[mt][h] = row_f(g, mt, h);\n",
        "      for (int h = 0; h < 2; ++h) xr[mt][h] = 1.5f + mt + h;\n"), (
        "      for (int e = 0; e < 2; ++e) sc[c][e] = col_f(g, c, e);\n",
        "      for (int e = 0; e < 2; ++e) sc[c][e] = 0.5f + c + e;\n")],
    # the epilogue's z chain left out
    "no_z": [("  constexpr int kPass = T::kSmem / kZSlot;\n  for (int g0 = 0; g0 < G;",
              "  constexpr int kPass = T::kSmem / kZSlot;\n  for (int g0 = 0; g0 < 0;")],
    "fu4": FU4,
    "prefetch": PREFETCH,
    "fu4_prefetch": FU4 + PREFETCH,
    # the ags form's column factors: one weight group a block, copied once
    # and read as unit 0's (right where (gs / ags) % 4 == 0)
    "ags_one_col": [
        ("    for (int i = tid - kLBN; i >= 0 && i < fu * kColChunks; i += kLThreads - kLBN) {\n",
         "    for (int i = tid - kLBN; i >= 0 && i < (AGS ? 1 : fu) * kColChunks;"
         " i += kLThreads - kLBN) {\n"),
        ("    return factor(cols[(f & (fu - 1)) * kLBM + wn + 4 * (2 * tq + e) + c]);\n",
         "    return factor(cols[(AGS ? 0 : (f & (fu - 1))) * kLBM + wn + 4 * (2 * tq + e) + c]);\n")],
}


def _time_shapes(cs, card, check=True):
    import torch
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import qgemm_grouped_plain
    from tmac_tpu_torch.ops.qgemm import kernel_for
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(0)
    rows = []
    for label, K, M, bits, gs, ags, N in SHAPES:
        qts = [cs.rand_qt_on_card(gen, K, M, bits, gs, card.dev) for _ in range(4)]
        for f32 in ((False, True) if gs == 32 else (False,)):
            qq = [dataclasses.replace(q, scales=q.scales.float(), sub=q.sub.float())
                  if f32 else q for q in qts]
            x = card.bf16(N, K)
            kw = dict(act_gs=ags) if ags else {}
            fn = kernel_for(qq[0], N, dispatch="chunk", **kw)
            row = dict(shape=label, f32=f32, N=N)
            try:
                row["ms"] = cs.graph_ms(lambda: [fn(x, q) for q in qq], reps=10) / 4
            except ValueError as e:
                row["refused"] = str(e)[:80]
            else:
                if check:
                    row["bitwise"] = bool(torch.equal(
                        fn(x, qq[0]), qgemm_grouped_plain(x, qq[0], act_gs=ags)))
            rows.append(row)
        del qts
    return rows


# the instances the shapes above take, whose ptxas report is printed (a
# parent's kernel may lack the scale type's argument)
WATCHED = ("group_mma_kernel<2,32,1,bf16>", "group_mma_kernel<2,64,0,bf16>",
           "group_mma_kernel<4,32,0,f32>", "group_mma_kernel<2,32,1>",
           "group_mma_kernel<2,64,0>")


def _ptxas(cs, log):
    """ptxas's registers and spills of the WATCHED kernels in an nvcc log."""
    report, kernel = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            kernel = f"group_mma_kernel<{','.join(cs.template_args(mangled))}>"
            if "group_mma_kernel" not in mangled:
                kernel = "?"
        elif ("registers" in ln or "spill" in ln) and kernel in WATCHED:
            report.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    return report


def _variant_libs(cs, names):
    """Build each variant's library, all nvcc processes at once -> name ->
    (path, ptxas lines of group_mma_kernel)."""
    from tmac_tpu_torch.ops.cuda import build
    src = (build.CSRC / "qgemm_grouped_large.cu").read_text()
    out_dir = ROOT / "_scratch" / "k4l_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: patch does not apply: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib_{name}.so"
        cmd = [build.nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        libs[name] = (None, log[-2000:]) if p.returncode else (lib, _ptxas(cs, log))
    return libs


def main():
    mode = sys.argv[1]
    if mode == "parent":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
    sys.path.insert(1, str(ROOT))
    import ctypes
    import chip_smoke as cs
    import tmac_tpu_torch
    from tmac_tpu_torch.ops.cuda import build
    t0 = time.time()
    if mode == "parent":
        logs = build.build(("qgemm_grouped",))
    else:
        logs = build.build(("qgemm_grouped", "qgemm_grouped_large", "qgemm_grouped_large_f32"))
    card = cs.Card()
    result = dict(mode=mode, package=str(Path(tmac_tpu_torch.__file__).parent),
                  card=card.smi, ptxas=_ptxas(cs, "\n".join(logs.values())))
    if mode == "variants":
        from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as gk
        libs = _variant_libs(cs, sys.argv[2:] or list(VARIANTS))
        result["build_s"] = round(time.time() - t0, 1)
        result["variants"] = {}
        for name, (path, ptxas) in libs.items():
            if path is None:
                result["variants"][name] = dict(nvcc_failed=ptxas)
                continue
            lib = ctypes.CDLL(str(path))
            ref = gk._lib_k4l()
            lib.tmac_group_gemm.argtypes = ref.tmac_group_gemm.argtypes
            lib.tmac_group_gemm.restype = ref.tmac_group_gemm.restype
            gk._lib_k4l = lambda f32=0, lib=lib: lib
            result["variants"][name] = dict(ptxas=ptxas, rows=_time_shapes(cs, card))
    else:
        result["build_s"] = round(time.time() - t0, 1)
        result["rows"] = _time_shapes(cs, card, check=mode == "new")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
