"""Architecture config wrapper and ``enable_kv_quant`` (the parts of
``repro/configs/common.py`` the port needs)."""

from __future__ import annotations

import dataclasses

from repro_torch.models.lm import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    family: str
    sub_quadratic: bool = False
    source: str = ""
    notes: str = ""


def enable_kv_quant(arch: ArchConfig) -> ArchConfig:
    """The same architecture with int8 KV caches (per-(token, KV head) fp32
    scales) on every GQA attention block."""

    def fix_block(b):
        if b.attn is not None and b.attn.kv_lora_rank is None:
            return dataclasses.replace(b, attn=dataclasses.replace(b.attn, kv_quant=True))
        return b

    m = arch.model
    model = dataclasses.replace(
        m,
        unit=tuple(fix_block(b) for b in m.unit),
        prologue=tuple(fix_block(b) for b in m.prologue),
        epilogue=tuple(fix_block(b) for b in m.epilogue),
        shared=tuple(fix_block(b) for b in m.shared),
    )
    return dataclasses.replace(arch, model=model)
