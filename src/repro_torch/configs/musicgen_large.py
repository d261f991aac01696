"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048, a decoder over EnCodec tokens.  Counterpart of
``repro/configs/musicgen_large.py`` (source arXiv:2306.05284); about 3.23 B
fp32 parameters (~12.9 GB).

Backbone only, as the reference: the EnCodec frontend is a stub, and the
inputs are precomputed frame embeddings ``(B, S, d)`` (``input_kind=
"embeddings"``); the 4-codebook delay-pattern head collapses to one
2048-way head."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig


def build(n_layers=48, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
          vocab=2048) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads)
    model = ModelConfig(
        name="musicgen-large", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_mlp", attn=attn, d_ff=d_ff),),
        n_repeats=n_layers, input_kind="embeddings",
    )
    return ArchConfig(model=model, family="audio", sub_quadratic=False,
                      source="arXiv:2306.05284",
                      notes="EnCodec frontend stubbed (precomputed frame embeddings); "
                            "sinusoidal positions replaced by rotary (DESIGN.md §5).")


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=128)
