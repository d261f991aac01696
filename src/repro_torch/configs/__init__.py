"""Architecture registry of the port: ``--arch <id>`` resolution.

Only kanformer-100m is ported; the other architectures of ``repro.configs``
wait for their block kinds (ROADMAP queue 1, item 13)."""

import importlib

ARCHS = {"kanformer-100m": "kanformer_100m"}


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
