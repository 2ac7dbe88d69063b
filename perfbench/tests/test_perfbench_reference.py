"""The plain reference against the port's plain path, both in fp32, at
the tiny size on the CPU: the decision logits, and three Adam steps of
the fusion step (losses, first gradients, changes). This is a test of
the reference, not the reference: it holds the two implementations of
the same model to each other where neither rounds."""
import importlib

import pytest
import torch

from perfbench import loop
from perfbench.steps import mfvit_port

ref = importlib.import_module("perfbench.reference.mfvit_ca")


def setup(tiny, traffic, seed):
    cfg, tr = tiny.json("configs", "tiny"), tiny.json("traffic", traffic)
    gen = torch.Generator().manual_seed(seed)
    params = ref.make_params(cfg, gen, "cpu")
    inputs = ref.make_inputs(cfg, tr, gen, "cpu")
    inputs = {k: v.float() if v.is_floating_point() else v
              for k, v in inputs.items()}
    return cfg, tr, params, inputs


@pytest.mark.parametrize("img", [32, 48])
def test_decision_logits_match_the_port(tiny, img):
    from mfvit_tpu_torch.train.steps import make_fusion_forward
    cfg, tr, params, inputs = setup(tiny, "tiny_serve", 11)
    tr["img_size"] = img
    gen = torch.Generator().manual_seed(12)
    inputs = ref.make_inputs(cfg, tr, gen, "cpu")
    xc, xe = inputs["cxr"][0].float(), inputs["enh"][0].float()
    models = mfvit_port.build(cfg, img, params, "cpu")
    got = sum(make_fusion_forward(compute_dtype=torch.float32,
                                  reference=True)(models, xc, xe))
    want = ref.serve_logits(params, cfg, xc, xe, rows=3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_three_adam_steps_match_the_port(tiny):
    from mfvit_tpu_torch.train import optim
    from mfvit_tpu_torch.train.steps import make_fusion_steps
    cfg, tr, params, inputs = setup(tiny, "tiny_train", 21)
    models = mfvit_port.build(cfg, tr["img_size"], params, "cpu")
    opt = optim.build_optimizer("adam", models.named_parameters(), tr["lr"])
    step, _ = make_fusion_steps(compute_dtype=torch.float32, reference=True)
    batches = [(inputs["cxr"][i], inputs["enh"][i], inputs["labels"][i])
               for i in range(3)]
    losses, grads, logits = [], None, None
    params0 = [p.detach().clone() for p in opt.params()]
    for i, (xc, xe, y) in enumerate(batches):
        loss, out = step(models, opt, xc, xe, y)
        losses.append(loss.item())
        if i == 0:
            grads = [p.grad.clone() for p in opt.params()]
            logits = out
    prog = {"losses": losses, "logits": logits,
            "grads": dict(zip(opt.names, grads)),
            "deltas": {n: p.detach() - p0 for n, p, p0
                       in zip(opt.names, opt.params(), params0)}}
    want = ref.train_steps(params, cfg, batches, tr["lr"], rows=3)
    nums, _ = loop.train_numbers(prog, want)
    assert nums["logit_max"] < 1e-4
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-2


def test_fp8_products_round_to_e4m3():
    t = torch.tensor([1.0, 1.0625, 448.0, -3.3])
    got = ref.to_fp8(t)
    assert got[2] == 448.0 and got[0] == 1.0
    assert (got - t).abs().max() <= 0.0625 * 3.3 + 1e-6
