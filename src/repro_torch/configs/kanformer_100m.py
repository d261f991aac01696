"""kanformer-100m: a ~100M decoder LM whose FFN sublayers are B-spline KAN
layers (G=5, P=3).  Counterpart of ``repro/configs/kanformer_100m.py``.

Full config: d=512, 8 heads (8 KV heads), 8 layers, kan_ff=1024, vocab
32000 — about 100M fp32 parameters (~0.4 GB)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.core.bspline import SplineGrid
from repro_torch.models.attention import AttnConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig


def build(n_layers=8, d_model=512, n_heads=8, n_kv=8, kan_ff=1024,
          vocab=32000, G=5, P=3) -> ArchConfig:
    attn = AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=d_model // n_heads)
    grid = SplineGrid(-1.0, 1.0, G, P)
    model = ModelConfig(
        name="kanformer-100m", d_model=d_model, vocab=vocab,
        unit=(BlockCfg("attn_kan", attn=attn, kan_grid=grid, kan_ff=kan_ff),),
        n_repeats=n_layers,
    )
    return ArchConfig(model=model, family="kan",
                      source="this work (paper technique integration)")


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_layers=2, d_model=64, n_heads=4, n_kv=4, kan_ff=96,
                 vocab=512, G=5, P=3)
