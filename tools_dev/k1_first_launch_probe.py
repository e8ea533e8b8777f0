"""K1's first launches in fresh processes on one card, against its plain
version: a probe for an intermittent mismatch at the start of a process.

    python tools_dev/k1_first_launch_probe.py [runs]     # default 24

The parent builds the kernels once, then starts `runs` child processes one
after another.  Each child draws BitNet-3B's wqkv (3200 x 9600, per-tensor
ternary weights) and a norm weight on the card, puts a few hundred MB on
the card first (as a model's weights are there before its first call),
then calls K1 with the norm fold at N = 1 (decode_plan's cluster size)
three times, each held to the plain version bit for bit, and prints one
JSON line.  The parent prints every child's line and a summary line last.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(seed: int) -> dict:
    import math

    import torch
    sys.path.insert(0, str(ROOT))
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    from tmac_tpu_torch.utils import nmse
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    K, M = 3200, 9600
    filler = [torch.randn((1 << 26,), generator=gen, device=dev) for _ in range(2)]
    f = torch.randint(1, 4, (4, K // 4, M), generator=gen, device=dev, dtype=torch.uint8)
    packed = f[0] | (f[1] << 2) | (f[2] << 4) | (f[3] << 6)
    scales = (0.5 + torch.rand((1, M), generator=gen, device=dev)) / math.sqrt(K)
    qt = QuantizedTensor(packed, None, scales, 2 * scales, 2, K, 1, 1, (K, M))
    norm = ((1.0 + 0.1 * torch.randn((K,), generator=gen, device=dev)).to(torch.bfloat16), 1e-5)
    x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
    want = k1.qgemm_fused_plain(x, qt, norm=norm)
    out = []
    for _ in range(3):
        got = k1.qgemm_fused(x, qt, norm=norm)
        torch.cuda.synchronize()
        out.append(dict(bitwise=bool(torch.equal(got, want)),
                        nmse=nmse(want.cpu().numpy(), got.cpu().numpy()),
                        max_abs_err=float((got - want).abs().max())))
    del filler
    return dict(seed=seed, ksplit=k1.decode_plan(1, K, M, 2, 0, 132)[0], calls=out)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        print(json.dumps(child(int(sys.argv[2]))), flush=True)
        return 0
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    sys.path.insert(0, str(ROOT))
    from tmac_tpu_torch.ops.cuda import build
    build.build(("qgemm_fused",))
    failed = 0
    for seed in range(runs):
        p = subprocess.run([sys.executable, __file__, "--child", str(seed)],
                           capture_output=True, text=True, timeout=300)
        line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        print(line or json.dumps(dict(seed=seed, rc=p.returncode, err=p.stderr[-2000:])),
              flush=True)
        ok = p.returncode == 0 and line and all(c["bitwise"] for c in json.loads(line)["calls"])
        failed += not ok
    print(json.dumps(dict(runs=runs, failed=failed)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
