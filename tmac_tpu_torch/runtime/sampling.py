"""Token sampling: greedy only, so far (the port of
``tmac_tpu/runtime/sampling.py``'s ``SamplerConfig`` and ``sample``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled
    min_p: float = 0.0         # 0 => disabled
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @property
    def has_penalties(self) -> bool:
        return (self.repeat_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


def sample(logits: torch.Tensor, cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32.  Greedy: the first index of
    the maximum, as jnp.argmax."""
    if cfg.temperature > 0.0 or cfg.has_penalties:
        raise NotImplementedError(
            "only greedy sampling is ported; temperature, filters and "
            "penalties come with the sampling slice")
    return torch.argmax(logits, dim=-1).to(torch.int32)
