"""deepseek-v2-lite [moe]: 27L d_model=2048 16H head_dim 128; MLA with a
512-dim KV latent and a 64-dim rope key; a dense SwiGLU first layer (d_ff
10944, the prologue) then 26 MoE layers of 64 routed experts (d_ff 1408,
top-6) beside 2 shared experts; vocab 102400.  Counterpart of
``repro/configs/deepseek_v2_lite.py`` (source arXiv:2405.04434); about
15.5 B fp32 parameters (~62.0 GB).  MLA caches are not pageable, so the
model serves on the static and dense continuous paths only."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig
from repro_torch.models.moe import MoEConfig


def build(n_layers=27, d_model=2048, n_heads=16, d_ff_expert=1408,
          vocab=102400, n_experts=64, top_k=6, n_shared=2, kv_lora=512,
          dense_ff=10944, head_dim=128, qk_rope=64) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
                      head_dim=head_dim, kv_lora_rank=kv_lora, qk_rope_dim=qk_rope)
    moe = MoEConfig(d_model=d_model, d_ff=d_ff_expert, n_experts=n_experts, top_k=top_k,
                    n_shared=n_shared)
    model = ModelConfig(
        name="deepseek-v2-lite", d_model=d_model, vocab=vocab,
        prologue=(BlockCfg("attn_mlp", attn=attn, d_ff=dense_ff),),
        unit=(BlockCfg("attn_moe", attn=attn, moe=moe),),
        n_repeats=n_layers - 1,
    )
    return ArchConfig(
        model=model, family="moe", sub_quadratic=False,
        source="arXiv:2405.04434",
        notes="MLA latent KV cache: serve caches only (kv_lora+rope)=576 "
              "dims/token instead of 2*16*128=4096 (7.1x cache cut).",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=3, d_model=64, n_heads=4, d_ff_expert=32,
                 vocab=512, n_experts=8, top_k=2, n_shared=1, kv_lora=16,
                 dense_ff=128, head_dim=16, qk_rope=8)
