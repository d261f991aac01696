"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) head_dim 128, q/k
RMS norm; every FFN a mixture of 64 SwiGLU experts of d_ff 1024, top-8,
vocab 50304.  Counterpart of ``repro/configs/olmoe_1b_7b.py`` (source
arXiv:2409.02060); about 6.8 B fp32 parameters (~27.3 GB)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig
from repro_torch.models.moe import MoEConfig


def build(n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024,
          vocab=50304, n_experts=64, top_k=8) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads, qk_norm=True)
    moe = MoEConfig(d_model=d_model, d_ff=d_ff, n_experts=n_experts, top_k=top_k)
    model = ModelConfig(
        name="olmoe-1b-7b", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_moe", attn=attn, moe=moe),),
        n_repeats=n_layers,
    )
    return ArchConfig(
        model=model, family="moe", sub_quadratic=False,
        source="arXiv:2409.02060",
        notes="EP: 64 experts / model=16 -> 4 experts per device.",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=32,
                 vocab=512, n_experts=8, top_k=2)
