"""Shared math helpers (the port's copy of ``tmac_tpu/utils.py``)."""

from __future__ import annotations

import numpy as np


def nmse(a, b) -> float:
    """Normalized mean squared error of b against reference a."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    denom = np.mean(np.square(a))
    if denom == 0:
        return float(np.mean(np.square(a - b)))
    return float(np.mean(np.square(a - b)) / denom)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def argmax_agreement(ref, got, tie_margin: float) -> float:
    """Share of rows (..., V) whose argmax in `got` is the reference's,
    counting a disagreement as agreement when the reference's own top-1
    lead over the chosen token, or over its runner-up, is below
    `tie_margin` (a near-tie that rounding noise may flip; the rule of
    tmac_tpu/tools/parity.py)."""
    ref = np.asarray(ref, np.float32).reshape(-1, np.shape(ref)[-1])
    got = np.asarray(got, np.float32).reshape(ref.shape)
    ok = 0
    for r, g in zip(ref, got):
        top, chosen = int(np.argmax(r)), int(np.argmax(g))
        srt = np.sort(r)
        if (top == chosen or r[top] - r[chosen] < tie_margin
                or srt[-1] - srt[-2] < tie_margin):
            ok += 1
    return ok / len(ref)
