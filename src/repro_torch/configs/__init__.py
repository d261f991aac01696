"""Architecture registry of the port: ``--arch <id>`` resolution.

kanformer-100m, the dense models (qwen1.5-0.5b, qwen2.5-3b, qwen1.5-32b,
gemma3-12b), the MoE models (olmoe-1b-7b; deepseek-v2-lite with MLA and a
dense prologue) and the recurrent ones (zamba2-1.2b, Mamba2 with a shared
attention block; xlstm-1.3b, mLSTM and sLSTM) and the two with non-token
inputs (paligemma-3b, patch embeddings before the text; musicgen-large,
frame embeddings) are ported: every architecture of ``repro.configs``.
The serving engine takes token prompts only, as the reference's, so the
last two run through ``models/lm.py`` and the trainer."""

import importlib

ARCHS = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2.5-3b": "qwen2_5_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-lite": "deepseek_v2_lite",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "kanformer-100m": "kanformer_100m",
    "paligemma-3b": "paligemma_3b",
    "musicgen-large": "musicgen_large",
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def get_config(name: str):
    return _module(name).config()


def get_reduced(name: str):
    return _module(name).reduced()


def list_configs():
    return list(ARCHS)
