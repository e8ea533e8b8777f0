"""BitNet b1.58 weight quantization, W1.58A8 (the port of
``tmac_tpu/convert/bitnet.py``).

The 1bitLLM/bitnet_b1_58-* and microsoft/BitNet checkpoints store
full-precision master weights; the ternary quantization is the BitNet
b1.58 recipe (absmean):

    gamma = mean(|W|)
    Wq    = RoundClip(W / gamma, -1, 1)      in {-1, 0, +1}
    Wdq   = Wq * gamma

stored as biased uint8 {1, 2, 3} (mid 2) under bits=2 with a per-tensor
scale, which routes qgemm onto the exact-int32 path (K1, K3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_bitnet(w_km: np.ndarray, k_shards: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(K, M) float master weights -> (wq uint8 {1, 2, 3}, scales, sub).

    scales/sub have k_shards rows (one per K-shard, identical values) so
    the tensor k-shards cleanly under tensor parallelism.  From 2^20
    weights the native library's version runs (its absmean sums in
    another order), as in the reference."""
    from tmac_tpu_torch import native
    if w_km.size >= (1 << 20) and native.available():
        return native.quantize_bitnet(np.asarray(w_km, np.float32), k_shards)
    M = w_km.shape[1]
    gamma = max(float(np.mean(np.abs(w_km)).astype(np.float32)), 1e-8)
    wq = np.clip(np.rint(w_km / gamma), -1, 1).astype(np.int8)
    wq = (wq + 2).astype(np.uint8)  # biased: mid = 2 for bits=2
    scales = np.full((k_shards, M), gamma, np.float32)
    return wq, scales, 2.0 * scales


def is_ternary(w: np.ndarray, tol: float = 0.0) -> bool:
    """True if the tensor is already exactly ternary * scale (pre-quantized
    checkpoints like 1bitLLM's tq variants)."""
    u = np.unique(w)
    if u.size > 3:
        return False
    nz = u[u != 0]
    if nz.size == 0:
        return True
    return bool(np.allclose(np.abs(nz), np.abs(nz[0]), atol=tol))
