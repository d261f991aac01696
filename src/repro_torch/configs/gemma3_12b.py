"""gemma3-12b [dense]: 48L (8 repeats of 5 local + 1 global) d_model=3840
16H (GQA kv=8) head_dim 256 d_ff=15360 vocab=262144, q/k RMS norm; the
local layers attend a sliding window of 1024 through a ring cache of 1024
slots.  Counterpart of ``repro/configs/gemma3_12b.py`` (source
hf:google/gemma-3-12b-pt); about 11.8 B fp32 parameters (~47 GB)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig


def build(n_repeats=8, d_model=3840, n_heads=16, n_kv=8, d_ff=15360,
          vocab=262144, head_dim=256, window=1024) -> ArchConfig:
    local = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                       head_dim=head_dim, window=window, qk_norm=True,
                       rope_theta=10000.0)
    glob = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=head_dim, window=None, qk_norm=True, rope_theta=1e6)
    unit = tuple([BlockCfg("attn_mlp", attn=local, d_ff=d_ff)] * 5
                 + [BlockCfg("attn_mlp", attn=glob, d_ff=d_ff)])
    model = ModelConfig(name="gemma3-12b", d_model=d_model, vocab=vocab,
                        unit=unit, n_repeats=n_repeats)
    return ArchConfig(
        model=model, family="dense", sub_quadratic=True,
        source="hf:google/gemma-3-12b-pt (config per pool; unverified tier)",
        notes="5:1 local:global — 5/6 of layers are O(window); long_500k "
              "runs with the global layers' KV cache sequence-sharded "
              "across the data axis (DESIGN.md §5).",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_repeats=1, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                 vocab=512, head_dim=16, window=8)
