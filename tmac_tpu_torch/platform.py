"""The card's hardware constants (the port's copy of ``tmac_tpu/platform.py``).

The JAX package maps a TPU kind to its roofline constants; the port maps an
NVIDIA card, by ``torch.cuda.get_device_name()``, to its public data-sheet
values (dense rates, without sparsity, at the part's full power limit):

  H100 SXM:  3.35 TB/s HBM3, 989 TFLOP/s bf16, 1979 TOP/s int8, 80 GB
  H100 NVL:  3.9 TB/s, 835 / 1671, 94 GB
  H100 PCIe: 2.0 TB/s, 756 / 1513, 80 GB
  H200 SXM:  4.8 TB/s, 989 / 1979, 141 GB

each with its shared memory a block may use (227 KB of an SM's 228) and
its L2 (50 MB).  A card may run below its power limit, and then slower:
whoever quotes a rate from these names the card's power limit beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str
    hbm_gbps: float            # device-memory bandwidth, GB/s
    bf16_tflops: float         # tensor cores, bf16, dense
    int8_tops: float           # tensor cores, int8, dense
    hbm_gib: float             # device memory, GB
    smem_kib: float = 227.0    # shared memory a block may use
    l2_mib: float = 50.0

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9


# matched in this order on the device name (the more specific names first)
_REGISTRY = (
    ("H200", DeviceSpec("H200", 4800.0, 989.0, 1979.0, 141.0)),
    ("H100 NVL", DeviceSpec("H100 NVL", 3900.0, 835.0, 1671.0, 94.0)),
    ("H100 PCIe", DeviceSpec("H100 PCIe", 2000.0, 756.0, 1513.0, 80.0)),
    ("H100", DeviceSpec("H100", 3350.0, 989.0, 1979.0, 80.0)),
)


def device_spec(kind: Optional[str] = None) -> DeviceSpec:
    """The spec of the given card name, or of the current CUDA device.
    Raises for a card this table does not hold, and without a card: a
    rate quoted for no card, or for another one, would be wrong."""
    if kind is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the card (device_spec(kind))")
        kind = torch.cuda.get_device_name(0)
    for name, spec in _REGISTRY:
        if name in kind:
            return dataclasses.replace(spec, kind=kind)
    raise ValueError(f"no spec for {kind!r}: the table holds "
                     f"{', '.join(name for name, _ in _REGISTRY)}")


def decode_speed_of_light_tps(model_bytes_per_token: float,
                              kind: Optional[str] = None) -> float:
    """Upper bound on single-stream decode tokens/s: every weight byte is
    read once per token from device memory."""
    return device_spec(kind).hbm_bytes_per_s / model_bytes_per_token
