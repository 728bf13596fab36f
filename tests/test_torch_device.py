"""The port's entry points run on the card or raise: with no CUDA device
and no `device` argument they never carry on on the CPU. `device="cpu"`
(what every CPU test passes) still works."""

import numpy as np
import pytest
import torch

from morphik_core_tpu_torch import device as tdevice
from morphik_core_tpu_torch.index.multivector_index import MultiVectorIndex
from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
from morphik_core_tpu_torch.ops import maxsim as tmax
from morphik_core_tpu_torch.ops.fde import FDEConfig


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _q8_pool():
    rng = np.random.default_rng(0)
    pool = [rng.standard_normal((n, 16)).astype(np.float32) for n in (3, 5)]
    return rng.standard_normal((4, 16)).astype(np.float32), tmax.quantize_pool_int8(pool)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdevice.default_device()


@pytest.mark.parametrize("entry", ["model", "index", "maxsim_q8"])
def test_entry_points_raise_without_a_card_and_device(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "model":
            ColQwenModel.init_random(ColQwenConfig.tiny())
        elif entry == "index":
            MultiVectorIndex(FDEConfig())
        else:
            q, (d8, ds, mask) = _q8_pool()
            tmax.maxsim_scores_q8(q, d8, ds, mask)


@pytest.mark.parametrize("entry", ["model", "index", "maxsim_q8"])
def test_entry_points_run_on_the_cpu_when_asked(no_card, entry):
    if entry == "model":
        model = ColQwenModel.init_random(ColQwenConfig.tiny(), device="cpu")
        assert model.device.type == "cpu" and model.proj_w.device.type == "cpu"
    elif entry == "index":
        assert MultiVectorIndex(FDEConfig(), device="cpu").device.type == "cpu"
    else:
        q, (d8, ds, mask) = _q8_pool()
        scores = tmax.maxsim_scores_q8(q, d8, ds, mask, device="cpu")
        assert scores.device.type == "cpu" and scores.shape == (2,) and torch.isfinite(scores).all()
