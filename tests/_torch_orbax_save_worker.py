"""One of two JAX processes (2 CPU devices each) that save one tree through
``mfvit_tpu.exp.checkpoint.save`` for tests/test_torch_port_interop.py:

    python _torch_orbax_save_worker.py PROCESS_ID NUM_PROCESSES HOST:PORT DIR

The tree (``known_tree``): a tiny ViT's parameters and its AdamW moments
after one update, replicated over the 4-device mesh; a (4, 6) leaf
sharded by rows, so that process 1 writes rows 2 and 3; and an int."""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mfvit_tpu.nn import vit as jvit  # noqa: E402

TINY = dict(img_size=32, patch=16, dim=32, depth=1, heads=2)


def known_tree() -> dict:
    params = jvit.init(jax.random.PRNGKey(3), jvit.ViTConfig("tiny", **TINY),
                       num_classes=3)
    tx = optax.adamw(1e-3, weight_decay=0.1)
    grads = jax.tree.map(lambda p: jnp.sin(p) + 0.1, params)
    _, state = tx.update(grads, tx.init(params), params)
    adam = state[0]
    return {"params": params,
            "adamw": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
            "rows": jnp.arange(24, dtype=jnp.float32).reshape(4, 6) * 0.5,
            "step": 7}


def main():
    pid, nproc, addr, path = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    from mfvit_tpu.exp import checkpoint
    from mfvit_tpu.parallel import mesh as pmesh
    pmesh.init_distributed(addr, num_processes=nproc, process_id=pid)
    mesh = pmesh.make_mesh(jax.device_count())
    tree = known_tree()
    step = tree.pop("step")
    rows = tree.pop("rows")
    tree = pmesh.replicate(tree, mesh)
    tree["rows"] = pmesh.shard_batch(rows, mesh)
    tree["step"] = step
    checkpoint.save(path, tree)
    print(f"SAVED {pid}", flush=True)


if __name__ == "__main__":
    main()
