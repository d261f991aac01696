"""Architecture config wrapper (the part of ``repro/configs/common.py`` the
port needs)."""

from __future__ import annotations

import dataclasses

from repro_torch.models.lm import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    family: str
    source: str = ""
