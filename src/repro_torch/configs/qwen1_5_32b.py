"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias.  Counterpart of ``repro/configs/qwen1_5_32b.py``
(source hf:Qwen/Qwen1.5-32B).  About 32 B parameters: 128 GB in fp32, more
than one 80 GB card holds, so only ``reduced()`` runs here."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig


def build(n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392,
          vocab=152064) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads, qkv_bias=True)
    model = ModelConfig(
        name="qwen1.5-32b", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_mlp", attn=attn, d_ff=d_ff),),
        n_repeats=n_layers,
    )
    return ArchConfig(
        model=model, family="dense", sub_quadratic=False,
        source="hf:Qwen/Qwen1.5-32B",
        notes="40 heads is not divisible by model=16: the sharding rules "
              "fall back to 8-way head sharding via ('model' subset) -> "
              "replication; see dist/sharding.py.",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=80, n_heads=5, n_kv=5, d_ff=192, vocab=512)
