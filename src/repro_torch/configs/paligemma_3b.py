"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216, SigLIP + gemma.  Counterpart of ``repro/configs/paligemma_3b.py``
(source arXiv:2407.07726); about 2.51 B fp32 parameters (~10.0 GB).

Backbone only, as the reference: the SigLIP vision tower is a stub, and the
inputs are ``N_PATCHES`` precomputed patch embeddings ``(B, 256, d)`` that
prefix the text tokens (``input_kind="mixed"``, the PaliGemma prefix-LM
layout; the prefix positions carry no labels)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig

N_PATCHES = 256


def build(n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384,
          vocab=257216, n_prefix=N_PATCHES) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads)
    model = ModelConfig(
        name="paligemma-3b", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_mlp", attn=attn, d_ff=d_ff),),
        n_repeats=n_layers, input_kind="mixed", n_prefix=n_prefix,
    )
    return ArchConfig(model=model, family="vlm", sub_quadratic=False,
                      source="arXiv:2407.07726",
                      notes="SigLIP frontend stubbed (precomputed patch embeddings); "
                            "kv=1 (MQA) replicates KV under TP.")


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=128,
                 vocab=512, n_prefix=8)
