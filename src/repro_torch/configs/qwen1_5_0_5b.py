"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias.  Counterpart of ``repro/configs/qwen1_5_0_5b.py``
(source hf:Qwen/Qwen1.5-0.5B); about 0.46 B fp32 parameters (~1.9 GB)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig


def build(n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=2816,
          vocab=151936) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads, qkv_bias=True)
    model = ModelConfig(
        name="qwen1.5-0.5b", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_mlp", attn=attn, d_ff=d_ff),),
        n_repeats=n_layers,
    )
    return ArchConfig(model=model, family="dense", sub_quadratic=False,
                      source="hf:Qwen/Qwen1.5-0.5B")


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512)
