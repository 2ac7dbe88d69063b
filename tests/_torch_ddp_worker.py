"""One rank of tests/test_torch_port_ddp.py's two-rank runs, on gloo and the
CPU (no jax):

    python _torch_ddp_worker.py RANK WORLD HOST:PORT DIR

Reads DIR/scenarios.pt (written by the test: configs, port state dicts,
global batches), runs each scenario's steps on this rank's row block of
every global batch, and writes DIR/rank{RANK}.pt: each scenario's state
dict and losses, and the messages of the refusals it provoked."""
import argparse
import os
import sys

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.nn import resnet, vit
from mfvit_tpu_torch.parallel import dist
from mfvit_tpu_torch.ssl import moco
from mfvit_tpu_torch.train import optim, steps


def rows(x, r, n):
    b = x.shape[0] // n
    return torch.from_numpy(x[r * b:(r + 1) * b])


def classifier(sc, r, n):
    model = vit.ViT(vit.ViTConfig(**sc["cfg"]), sc["classes"])
    model.load_state_dict(sc["state"])
    opt = optim.build_optimizer("sgd", model.named_parameters(), sc["lr"])
    train_step, _ = steps.make_classifier_steps(compute_dtype=torch.float32)
    losses = []
    for _ in range(sc["steps"]):
        loss, _ = train_step(model, opt, rows(sc["imgs"], r, n),
                             rows(sc["labels"], r, n))
        losses.append(loss.item())
    return model, losses


def backbone_cfg(kind, spec):
    return (vit.ViTConfig(**spec) if kind == "vit"
            else resnet.get_config(spec))


def moco_run(sc, r, n):
    model = moco.MoCo(moco.MoCoConfig(**sc["moco"]),
                      backbone_cfg(*sc["backbone"]))
    model.load_state_dict(sc["state"])
    opt = optim.build_optimizer("sgd", model.trainable(), sc["lr"])
    step = moco.make_pretrain_step(model.cfg, compute_dtype=torch.float32)
    losses = []
    for q, k in zip(sc["q"], sc["k"]):
        losses.append(step(model, opt, rows(q, r, n), rows(k, r, n),
                           sc["m"]).item())
    return model, losses


def refusals(n) -> dict:
    """What a group of ``n`` ranks must refuse: a data axis that is not
    the world, a global batch the ranks do not divide, and a queue whose
    length the global key batch does not divide."""
    out = {}
    ns = argparse.Namespace(mesh_devices=n + 1, batch_size=4 * n,
                            device="cpu")
    try:
        common.setup_mesh(ns)
    except SystemExit as e:
        out["mesh_devices"] = str(e)
    ns = argparse.Namespace(mesh_devices=None, batch_size=4 * n + 1,
                            device="cpu")
    try:
        common.setup_mesh(ns)
    except ValueError as e:
        out["batch"] = str(e)
    cfg = moco.MoCoConfig(dim=8, mlp_dim=16, K=12)
    model = moco.MoCo(cfg, vit.ViTConfig("tiny", img_size=32, patch=16,
                                         dim=32, depth=1, heads=2))
    x = torch.zeros(4, 32, 32, 3)  # K % 4 == 0, K % (4 n) != 0
    try:
        moco.forward_v2_queue(model, x, x, 0.99,
                              compute_dtype=torch.float32)
    except ValueError as e:
        out["queue"] = str(e)
    return out


def main():
    r, n, addr, root = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4])
    torch.set_num_threads(1)
    dist.init_distributed(addr, n, r, device_type="cpu", timeout_s=120)
    scen = torch.load(os.path.join(root, "scenarios.pt"), weights_only=False)
    out = {"refusals": refusals(n)}
    for name, sc in scen.items():
        run = classifier if sc["kind"] == "classifier" else moco_run
        model, losses = run(sc, r, n)
        out[name] = {"state": {k: v.clone() for k, v in
                               model.state_dict().items()},
                     "losses": losses}
    torch.save(out, os.path.join(root, f"rank{r}.pt"))
    dist.shutdown()
    print(f"RANK {r} DONE")


if __name__ == "__main__":
    main()
