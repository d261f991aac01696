"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) head_dim 128
d_ff=11008 vocab=151936, QKV bias, rope theta 1e6.  Counterpart of
``repro/configs/qwen2_5_3b.py`` (source hf:Qwen/Qwen2.5-3B)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig


def build(n_layers=36, d_model=2048, n_heads=16, n_kv=2, d_ff=11008,
          vocab=151936) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=128, qkv_bias=True, rope_theta=1e6)
    model = ModelConfig(
        name="qwen2.5-3b", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_mlp", attn=attn, d_ff=d_ff),),
        n_repeats=n_layers,
    )
    return ArchConfig(
        model=model, family="dense", sub_quadratic=False,
        source="hf:Qwen/Qwen2.5-3B",
        notes="kv=2 < model axis: KV heads replicate under TP; Q heads shard.",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=512)
