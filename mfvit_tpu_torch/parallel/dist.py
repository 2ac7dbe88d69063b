"""Multi-process data parallelism over ``torch.distributed``, the port of
``mfvit_tpu/parallel/mesh.py`` and ``hostput.py`` in the reference's own
design (one process a card, NCCL on the card and gloo on the CPU): every
rank holds the whole model and takes its row block of each global batch;
the gradients are averaged across the ranks before the optimizer steps,
MoCo's keys are all-gathered and its BatchNorm statistics averaged, and
rank 0 alone prints and writes files.

JAX runs one program over a device mesh; the port runs one process per
card. ``--mesh-devices N`` in one process therefore spawns N ranks here
(``spawn_ranks``, the reference's ``mp.spawn``), each on ``cuda:<rank>``
(or the CPU under ``--device cpu``), over a rendezvous on this host.

Every function is a no-op at world size 1 (no process group), so the
one-process paths run as they did."""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import socket
import tempfile
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

GRAD_BUCKET_BYTES = 32 << 20  # fp32 bytes a gradient all-reduce carries

_DEVICE = {"device": torch.device("cpu")}


def active() -> bool:
    """True inside an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def device() -> torch.device:
    """This rank's device: the collectives' tensors live there."""
    return _DEVICE["device"]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device_type: str = "cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> torch.device:
    """Join the process group (``mesh.init_distributed``, :35-53) and return
    this rank's device. ``coordinator`` "host:port" rendezvouses over
    ``tcp://`` with ``num_processes`` ranks, this one ``process_id``;
    without it the group comes from torchrun's environment (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and a
    given count or id overrides the environment's. The backend is NCCL for
    ``device_type`` "cuda" and gloo for "cpu" (``backend`` forces one).
    The card is ``cuda:<LOCAL_RANK>``, or ``cuda:<process_id mod the
    visible cards>``. A missing card or an unreachable coordinator
    raises: nothing falls back to one process."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed training on --device cuda: "
                               "CUDA is not available here (pass --device "
                               "cpu for gloo ranks on the CPU)")
    elif device_type != "cpu":
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            num_processes = (num_processes if num_processes is not None
                             else int(os.environ["WORLD_SIZE"]))
            process_id = (process_id if process_id is not None
                          else int(os.environ["RANK"]))
        init_method = f"tcp://{coordinator}"
    else:
        init_method = "env://"
    world_size = -1 if num_processes is None else int(num_processes)
    rank_id = -1 if process_id is None else int(process_id)
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is not None:
            idx = int(local)
        else:
            who = rank_id if rank_id >= 0 else int(os.environ["RANK"])
            idx = who % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
    else:
        dev = torch.device("cpu")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE["device"] = dev
    return dev


def shutdown() -> None:
    """Leave the process group (no-op outside one)."""
    if active():
        dist.destroy_process_group()
    _DEVICE["device"] = torch.device("cpu")


def assert_divisible(global_batch: int, n: Optional[int] = None) -> None:
    """``mesh.assert_divisible`` (:94): the global batch splits evenly over
    the ``n`` ranks (the group's world size by default)."""
    n = world() if n is None else n
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"the {n} ranks of the data axis")


def local_row_block(n_rows: int, n: Optional[int] = None,
                    r: Optional[int] = None) -> tuple:
    """This rank's contiguous row range [start, stop) of ``n_rows`` global
    rows (``hostput.local_row_block``, :43-54)."""
    n = world() if n is None else n
    r = rank() if r is None else r
    if n_rows % n:
        raise ValueError(f"{n_rows} rows not divisible by {n} processes")
    per = n_rows // n
    return r * per, (r + 1) * per


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the rows in rank order, no
    gradient (``ssl/moco.py::_gather``, :250-256). ``x`` moves to the
    group's device for the collective and comes back on its own."""
    if world() == 1:
        return x
    src = x.detach().to(device()).contiguous()
    parts = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, no gradient (the loss a step
    reports, JAX's ``pmean``)."""
    if world() == 1:
        return x
    out = x.detach().to(device()).clone()
    dist.all_reduce(out)
    return (out / world()).to(x.device)


class _AllSum(torch.autograd.Function):
    """The sum over the ranks; its transpose sums the cotangents."""

    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks as a differentiable function: the
    backward sums the cotangents over the ranks too, as the transpose of
    JAX's ``psum`` does."""
    if world() == 1:
        return x
    return _AllSum.apply(x)


def _buckets(tensors: Sequence[torch.Tensor], limit: int) -> Iterable[list]:
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() * 4 > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * 4
    if bucket:
        yield bucket


def mean_grads(params: Iterable[torch.Tensor]) -> None:
    """Replace each gradient by its mean over the ranks, in fp32, after
    ``backward()`` and before the optimizer's step (``pmean`` of the
    gradients, ``mfvit_tpu/ssl/moco.py:427-431``). The gradients travel
    flattened, in buckets of GRAD_BUCKET_BYTES; a parameter without a
    gradient (a frozen one) is left out on every rank alike."""
    n = world()
    if n == 1:
        return
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads, GRAD_BUCKET_BYTES):
        flat = _flatten_dense_tensors([g.float() for g in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        for g, s in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(s)


def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``, in
    place: the same starting weights everywhere, after building and
    loading."""
    if world() == 1:
        return
    for t in module.state_dict().values():
        if t.device != device():
            raise ValueError(f"broadcast_state: a tensor on {t.device}, "
                             f"the group's device is {device()}")
        dist.broadcast(t, src=0)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(r: int, module: str, argv: list, n: int, port: int,
               device_type: str, out_dir: str) -> None:
    """One spawned rank: ``module.main`` over ``argv`` and this rank's
    rendezvous flags; its return value is pickled to ``out_dir``."""
    if device_type == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    flags = ["--dist-coordinator", f"127.0.0.1:{port}",
             "--dist-num-processes", str(n), "--dist-process-id", str(r)]
    try:
        out = importlib.import_module(module).main(list(argv) + flags)
    finally:
        shutdown()
    with open(os.path.join(out_dir, f"{r}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(module: str, argv: Sequence[str], n: int,
                device_type: str) -> list:
    """``--mesh-devices n`` in one process: ``n`` ranks of ``module``'s
    ``main(argv)`` (the reference's ``mp.spawn``), rank r on ``cuda:r``
    (gloo ranks on the CPU under ``device_type`` "cpu"), rendezvousing on
    a free port of 127.0.0.1. Returns each rank's return value, in rank
    order; a rank that fails ends the others and raises here."""
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise SystemExit(f"--mesh-devices {n}: {have} CUDA devices are "
                             "visible here")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main,
                           args=(module, list(argv), n, free_port(),
                                 device_type, out_dir),
                           nprocs=n, join=True, start_method="spawn")
        outs = []
        for r in range(n):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs
