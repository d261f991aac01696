"""zamba2-1.2b [hybrid]: 38 layers, d_model 2048, Mamba2 (d_state 64,
expand 2, head_dim 64: 64 SSM heads) plus ONE shared attention block (32
heads of 64, SwiGLU d_ff 8192) invoked at 6 depths; vocab 32000.
Counterpart of ``repro/configs/zamba2_1_2b.py`` (source arXiv:2411.15242).

Layer layout: 6 x [5 mamba2 + shared attention] + 2 mamba2.  As in the
reference, the unit's sixth block keeps its own stacked attention
parameters (6 copies, 402.7 M) that nothing reads: every invocation uses
``params["shared"][0]``.  1.354 B fp32 parameters (~5.42 GB)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig
from repro_torch.models.ssm import Mamba2Config


def build(n_repeats=6, mamba_per_unit=5, tail=2, d_model=2048, n_heads=32,
          n_kv=32, d_ff=8192, vocab=32000, d_state=64) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads)
    mamba = Mamba2Config(d_model=d_model, d_state=d_state)
    shared_attn = BlockCfg("attn_mlp", attn=attn, d_ff=d_ff)
    unit = tuple([BlockCfg("mamba2", mamba=mamba)] * mamba_per_unit
                 + [BlockCfg("attn_mlp", attn=attn, d_ff=d_ff, shared_id=0)])
    model = ModelConfig(
        name="zamba2-1.2b", d_model=d_model, vocab=vocab,
        unit=unit, n_repeats=n_repeats,
        epilogue=tuple([BlockCfg("mamba2", mamba=mamba)] * tail),
        shared=(shared_attn,),
    )
    return ArchConfig(
        model=model, family="hybrid", sub_quadratic=True,
        source="arXiv:2411.15242",
        notes="long_500k: SSM state is O(1); the shared-attn KV cache "
              "seq-shards across the data axis.",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_repeats=1, mamba_per_unit=2, tail=1, d_model=64,
                 n_heads=4, n_kv=4, d_ff=128, vocab=512, d_state=16)
