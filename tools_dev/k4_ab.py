"""K4 and K7 (the decode matmul's earlier forms) per call, on one card, for
an A/B of two packages.

    python tools_dev/k4_ab.py new            # this checkout's package
    python tools_dev/k4_ab.py parent DIR     # the package under DIR

Each mode prints one JSON line: per form the ms of one layer's calls at
N = 1 (K4: the four linears of Llama-2-7B W2 g128, Llama-3.1-8B Q4_K's
f32 gs 32, Llama-2-7B W2 at ags 32 and Llama-3.1-8B W3 g128; K7: a
Mixtral-8x7B layer's two routed experts, gate_up and down, at W2 g128 and
at Q4_K's f32 gs 32), each call a CUDA graph over as many weight copies
as make 120 MB (at most 8), so the weights are cold in the 50 MB L2.  Run
parent, new, new, parent on one card: a card's power limit moves absolute
times between machines.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, bits, gs, f32 scales, [(K, M)] of a layer's four linears, ags)
LLAMA2 = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))
LLAMA3 = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
K4_FORMS = (("L b2 g128", 2, 128, False, LLAMA2, 0),
            ("G b4 g32 f32", 4, 32, True, LLAMA3, 0),
            ("L7 b2 g128 ags32", 2, 128, False, LLAMA2, 32),
            ("L3 b3 g128", 3, 128, False, LLAMA3, 0))
K7_FORMS = (("M K7 b2 g128", 2, 128, False), ("GM K7 b4 g32 f32", 4, 32, True))


def main():
    mode = sys.argv[1]
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs   # this checkout's, which imports the package lazily
    if mode == "parent":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
    import tmac_tpu_torch
    from tmac_tpu_torch.models.moe import stack_experts
    from tmac_tpu_torch.ops.cuda import build
    from tmac_tpu_torch.ops.cuda import expert_kernel as k7
    from tmac_tpu_torch.ops.qgemm import fuse_m, kernel_for
    t0 = time.time()
    build.build(("qgemm_grouped", "qgemm_expert"))
    build_s = round(time.time() - t0, 1)
    card = cs.Card()
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(0)

    def qt(K, M, bits, gs, f32):
        return cs.rand_qt_on_card(gen, K, M, bits, gs, card.dev,
                                  torch.float32 if f32 else torch.bfloat16)

    out = {}
    for name, bits, gs, f32, shapes, ags in K4_FORMS:
        tot = 0.0
        for K, M in shapes:
            K = 11264 if bits == 2 and K == 11008 else K   # the package's padding
            n = max(1, min(8, int(120e6 // (K * M * bits / 8))))
            qts = [qt(K, M, bits, gs, f32) for _ in range(n)]
            x = card.bf16(1, K)
            kw = dict(act_gs=ags) if ags else {}
            fn = kernel_for(qts[0], 1)
            tot += cs.graph_ms(lambda: [fn(x, q, **kw) for q in qts]) / n
            del qts
        out[name] = round(tot, 5)
    for name, bits, gs, f32 in K7_FORMS:
        gu = stack_experts([fuse_m([qt(4096, 14336, bits, gs, f32) for _ in range(2)])
                            for _ in range(8)])
        dn = stack_experts([qt(14336, 4096, bits, gs, f32) for _ in range(8)])
        idx = torch.tensor([1, 6], dtype=torch.int32, device=card.dev)
        x, xd = card.bf16(1, 4096), card.bf16(2, 1, 2 * 14336).float()
        out[name] = round(cs.graph_ms(lambda: [k7.qgemm_experts(x, gu, idx),
                                               k7.qgemm_experts(xd, dn, idx, glu=True)]), 5)
        del gu, dn
    print(json.dumps(dict(mode=mode, package=str(Path(tmac_tpu_torch.__file__).parent),
                          build_s=build_s, ms=out, card=card.smi)), flush=True)


if __name__ == "__main__":
    main()
