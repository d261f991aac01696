"""xlstm-1.3b [ssm]: 48 blocks at a 7:1 mLSTM:sLSTM ratio (xLSTM[7:1]),
d_model 2048, 4 heads, vocab 50304; no separate FFN: each mLSTM block
carries its own pf=2 up/down projections (``d_inner`` 4096, ``head_dim``
1024).  Counterpart of ``repro/configs/xlstm_1_3b.py`` (source
arXiv:2405.04517, unverified tier).  3.40 B fp32 parameters (~13.6 GB);
each mLSTM layer keeps a 4 x 1024 x 1024 fp32 matrix memory per request
(705 MB over the 42 of them)."""

from repro_torch.configs.common import ArchConfig
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import ModelConfig
from repro_torch.models.xlstm import XLSTMConfig


def build(n_repeats=6, mlstm_per_unit=7, d_model=2048, n_heads=4,
          vocab=50304) -> ArchConfig:
    xc = XLSTMConfig(d_model=d_model, n_heads=n_heads)
    unit = tuple([BlockCfg("mlstm", xlstm=xc)] * mlstm_per_unit
                 + [BlockCfg("slstm", xlstm=xc)])
    model = ModelConfig(
        name="xlstm-1.3b", d_model=d_model, vocab=vocab,
        unit=unit, n_repeats=n_repeats,
    )
    return ArchConfig(
        model=model, family="ssm", sub_quadratic=True,
        source="arXiv:2405.04517 (unverified tier)",
        notes="O(1) decode state; recurrent scan is the paper-faithful "
              "baseline — the chunked-parallel mLSTM is a §Perf item.",
    )


def config() -> ArchConfig:
    return build()


def reduced() -> ArchConfig:
    return build(n_repeats=1, mlstm_per_unit=2, d_model=64, n_heads=2, vocab=512)
