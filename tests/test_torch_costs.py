"""The analytic cost helpers (``models/costs.py``) against the JAX package.

For every registered architecture, full and reduced: ``n_params``,
``n_active_params``, ``model_flops`` (train, prefill, decode),
``analytic_hbm_bytes`` (the three modes, at the reference's defaults and at
one device, ``tp = 1``, fp32 parameters) and ``recurrent_adders`` equal the
reference's exactly: integers, and floats from the same arithmetic in the
same order.  The port sizes everything on the meta device: no parameter or
cache memory is allocated, which a dispatch mode that refuses any tensor off
the meta device checks at the full widths (qwen1.5-32b's caches alone would
take tens of GB).
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro import configs as jconfigs
from repro.models import costs as jcosts
from repro_torch import configs as tconfigs
from repro_torch.models import costs as tcosts

CASES = [(arch, full) for arch in tconfigs.list_configs() for full in (True, False)]
MODES = ("train", "prefill", "decode")
HBM_SETTINGS = ({"n_devices": 4}, {"n_devices": 1, "tp": 1, "param_bytes": 4})


def _models(arch: str, full: bool):
    get = "get_config" if full else "get_reduced"
    return getattr(jconfigs, get)(arch).model, getattr(tconfigs, get)(arch).model


class MetaOnly(TorchDispatchMode):
    """Refuses, before it runs, any op that would make or read a tensor
    off the meta device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        device = kwargs.get("device")
        tensors = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        on_meta = all(t.device.type == "meta" for t in tensors) and (
            torch.device(device).type == "meta" if device is not None else bool(tensors))
        if not on_meta:
            raise AssertionError(f"{func} would allocate off the meta device")
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch,full", CASES)
def test_param_counts_and_model_flops_equal_reference(arch, full):
    jm, tm = _models(arch, full)
    assert tcosts.n_params(tm) == jcosts.n_params(jm)
    assert tcosts.n_active_params(tm) == jcosts.n_active_params(jm)
    for mode in MODES:
        for tokens in (1, 512, 3 * 4096):
            assert tcosts.model_flops(tm, tokens, mode) == jcosts.model_flops(jm, tokens, mode)


@pytest.mark.parametrize("arch,full", CASES)
def test_analytic_hbm_bytes_equal_reference(arch, full):
    jm, tm = _models(arch, full)
    with MetaOnly():
        for mode in MODES:
            for kw in HBM_SETTINGS:
                got = tcosts.analytic_hbm_bytes(tm, global_batch=8, seq=256, mode=mode, **kw)
                want = jcosts.analytic_hbm_bytes(jm, global_batch=8, seq=256, mode=mode, **kw)
                assert got == want, (mode, kw, got, want)


@pytest.mark.parametrize("arch,full", CASES)
def test_recurrent_adders_equal_reference(arch, full):
    jm, tm = _models(arch, full)
    for mode in MODES:
        for batch, T in ((8, 1), (8, 256), (3, 4096)):
            assert (tcosts.recurrent_adders(tm, batch, T, mode)
                    == jcosts.recurrent_adders(jm, batch, T, mode))


def test_costs_see_moe_and_recurrent_blocks():
    """The cases above cover more than zeros: routed experts lower the
    active count, the recurrent mLSTM and sLSTM add terms."""
    _, olmoe = _models("olmoe-1b-7b", True)
    assert tcosts.n_active_params(olmoe) < tcosts.n_params(olmoe) / 4
    _, xlstm = _models("xlstm-1.3b", True)
    adders = tcosts.recurrent_adders(xlstm, 8, 256, "train")
    assert adders["flops"] > 0 and adders["bytes"] > 0


def test_meta_only_mode_refuses_an_allocation():
    with MetaOnly(), pytest.raises(AssertionError, match="off the meta device"):
        torch.zeros(3)
