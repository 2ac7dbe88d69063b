"""The control at a size a test run holds: the port's int8 serving path
(serving) and the reference trained with fp8 products (training) fail
the tiny cell's limits on every seed, where the program passes them."""
import importlib

import pytest
import torch

from perfbench import calibrate
from perfbench.tests.conftest import TINY_LIMITS

SEEDS = [3, 2 ** 31 + 9, 77]


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(tiny, seed):
    cfg, tr = tiny.json("configs", "tiny"), tiny.json("traffic", "tiny_serve")
    ref = importlib.import_module("perfbench.reference.mfvit_ca")
    step = importlib.import_module("perfbench.steps.serve_pairs")
    r = calibrate.serve_readings(step, cfg, tr, seed, torch.device("cpu"),
                                 ref, 0.2)
    lim = TINY_LIMITS["t.serve"]
    assert all(r["program"][k] <= v for k, v in lim.items())
    assert any(r["fp8"][k] > v for k, v in lim.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_half_batch_fail(tiny, seed):
    cfg, tr = tiny.json("configs", "tiny"), tiny.json("traffic", "tiny_train")
    ref = importlib.import_module("perfbench.reference.mfvit_ca")
    step = importlib.import_module("perfbench.steps.fusion_train")
    r = calibrate.train_readings(step, cfg, tr, seed, torch.device("cpu"),
                                 ref)
    lim = {k: v for k, v in TINY_LIMITS["t.train"].items()
           if k != "nonfinite_losses"}    # a run's, not the first steps'
    assert all(r["program"][k] <= v for k, v in lim.items())
    for bad in ("fp8", "half_batch"):
        assert any(r[bad][k] > v for k, v in lim.items()), bad
