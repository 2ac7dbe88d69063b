"""The rest of a run with the timed path broken underneath: each fault a
cell can have makes ``correct`` false (tiny size, CPU, the harness's look
for a card skipped); the unbroken run is correct."""
import pytest
import torch

from perfbench import faults, harness, loop

CASES = [("t.serve", "answer_altered"), ("t.serve", "half_batch"),
         ("t.train", "half_batch"), ("t.train", "state_unchanged")]


@pytest.mark.parametrize("cell,kind", CASES)
def test_fault_makes_the_run_incorrect(tiny, cell, kind):
    with faults.planted(kind):
        r = harness.run_cell(cell, 2 ** 31 + 5, 0.3, False,
                             device=torch.device("cpu"), files=tiny)
    # failed counts what attempted counts: pairs served, steps run
    assert r["correct"] is False and 0 < r["failed"] <= r["attempted"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", ["t.serve", "t.train"])
def test_unbroken_run_is_correct(tiny, cell):
    r = harness.run_cell(cell, 2 ** 31 + 5, 0.3, False,
                         device=torch.device("cpu"), files=tiny)
    assert r["correct"] is True


def test_half_batch_in_training_shows_in_the_gradient(tiny):
    """The fault answers for the whole batch, so the logits pass; the
    first gradient, over half the rows, does not."""
    with faults.planted("half_batch"):
        r = harness.run_cell("t.train", 2 ** 31 + 5, 0.3, False,
                             device=torch.device("cpu"), files=tiny)
    c = r["checks"]
    assert c["logit_rms"]["value"] <= c["logit_rms"]["limit"]
    assert c["grad_err"]["value"] > c["grad_err"]["limit"]
    steps = tiny.json("traffic", "tiny_train")["checked_steps"]
    assert r["failed"] == steps and r["attempted"] > steps


def test_one_batch_wrong_shows_in_batch_rms():
    """An error in one batch of many: the whole window's rms stays under
    what the worst batch's reads."""
    gen = torch.Generator().manual_seed(1)
    ref = [torch.randn(64, 3, generator=gen) for _ in range(40)]
    got = [r + 0.01 * torch.randn(64, 3, generator=gen) for r in ref]
    got[7] = got[7] + 0.5 * torch.randn(64, 3, generator=gen)
    nums = loop.batch_numbers(got, ref)
    assert nums["batch_rms"] == max(nums["batch_gaps"]) > 0.4
    assert nums["logit_rms"] < 0.1
    assert max(range(40), key=nums["batch_gaps"].__getitem__) == 7


def test_a_loss_gone_nonfinite_in_the_window_is_incorrect(tiny, monkeypatch):
    from mfvit_tpu_torch.train import steps as steps_mod

    make = steps_mod.make_fusion_steps

    def nan_after_first(**kw):
        train_step, eval_step = make(**kw)
        calls = []

        def step(*a):
            loss, out = train_step(*a)
            calls.append(1)
            return (loss * float("nan") if len(calls) > 4 else loss), out
        return step, eval_step

    monkeypatch.setattr(steps_mod, "make_fusion_steps", nan_after_first)
    r = harness.run_cell("t.train", 2 ** 31 + 5, 0.3, False,
                         device=torch.device("cpu"), files=tiny)
    assert r["correct"] is False
    n = r["checks"]["nonfinite_losses"]["value"]
    assert n > 0 and r["failed"] == n

