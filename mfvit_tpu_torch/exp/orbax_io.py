"""Read the JAX package's orbax checkpoints without JAX or orbax, the
counterpart of ``mfvit_tpu/exp/checkpoint.py::restore`` (:60-74) for what
its ``save`` (:32-57) writes.

An orbax 0.11 checkpoint directory holds ``_METADATA``, a JSON file that
names every leaf of the tree by its path (``key_metadata``: ``key_type`` 1
for a sequence index, 2 for a dict key) and says how the arrays are stored
(``use_ocdbt``, ``use_zarr3``). Each array is a zarr array whose name is
its path joined by dots, in an OCDBT key-value store at the directory's
root (``manifest.ocdbt``, which also names the ``ocdbt.process_N``
subtrees a multi-process save writes) or, without OCDBT, in a folder of
its own. The chunks are zstd frames. ``tensorstore`` reads all of it; it
is imported inside the functions that need it, so that every module of
the port imports on a host without it (the card's), where ``read_tree``
refuses the directory and names the converter, ``python -m
mfvit_tpu_torch.tools.convert_orbax``, to run on the host that wrote the
checkpoint.

``read_tree`` returns what JAX's ``restore(path)`` returns: nested dicts
and lists of numpy arrays (a namedtuple's fields as a dict, a tuple as a
list), None for an empty optax state, {} and [] for empty nodes, every
array in its stored dtype (a bf16 leaf as an ``ml_dtypes`` array;
``to_torch`` takes it to ``torch.bfloat16`` through a uint16 view).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

CONVERTER = "python -m mfvit_tpu_torch.tools.convert_orbax"
# what JAX's restore gives for a leaf orbax did not store an array for
EMPTY = {"None": lambda: None, "Dict": dict, "List": list}
KINDS = ("serving", "branch", "pretrain")


def _tensorstore(path: str, kind: str | None):
    """The ``tensorstore`` module, or SystemExit naming ``path`` and the
    converter command for a checkpoint of ``kind``."""
    try:
        import tensorstore
    except ImportError:
        kinds = kind or "|".join(KINDS)
        raise SystemExit(
            f"{path}: a JAX orbax checkpoint directory, and this host has "
            "no tensorstore to read it. On the host that wrote it, run "
            f"`{CONVERTER} {path} <file> --kind {kinds}` with this run's "
            "arch flags, and pass the file it writes instead") from None
    return tensorstore


def read_metadata(path: str) -> dict:
    """The checkpoint's ``_METADATA``; SystemExit if ``path`` has none."""
    meta = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta):
        raise SystemExit(f"{path}: a directory without _METADATA, so not an "
                         "orbax checkpoint")
    with open(meta) as f:
        return json.load(f)


def _leaf_spec(path: str, name: str, meta: dict) -> dict:
    if meta.get("use_ocdbt", True):
        kv = {"driver": "ocdbt", "base": f"file://{path}/", "path": name}
    else:
        kv = {"driver": "file", "path": os.path.join(path, name)}
    return {"driver": "zarr3" if meta.get("use_zarr3") else "zarr",
            "kvstore": kv}


class _Seq(dict):
    """A node indexed by sequence positions, a list once complete."""


def _finish(node):
    if isinstance(node, _Seq):
        n = len(node)
        if sorted(node) != list(range(n)):
            raise ValueError(f"sequence indices {sorted(node)} are not "
                             f"0..{n - 1}")
        return [_finish(node[i]) for i in range(n)]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


def read_tree(path: str, kind: str | None = None):
    """The tree the orbax checkpoint at ``path`` holds, as JAX's
    ``restore(path)`` gives it (module docstring). Without tensorstore
    this raises SystemExit naming the converter and ``kind`` (``serving``,
    ``branch`` or ``pretrain``), the file it should write."""
    path = os.path.abspath(path)
    meta = read_metadata(path)
    ts = _tensorstore(path, kind)
    ctx = ts.Context()
    root: dict = {}
    pending = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = root
        for i, k in enumerate(keys):
            seq = k["key_type"] == 1
            key = int(k["key"]) if seq else k["key"]
            if i == 0 and seq:
                raise ValueError(f"{path}: a tree whose root is a sequence")
            if i + 1 < len(keys):
                nxt = keys[i + 1]["key_type"] == 1
                node = node.setdefault(key, _Seq() if nxt else {})
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            if value["value_type"] not in EMPTY:
                raise ValueError(f"{path}: leaf {entry['key_metadata']} of "
                                 f"type {value['value_type']!r} holds no "
                                 "array")
            node[key] = EMPTY[value["value_type"]]()
        else:
            name = ".".join(str(k["key"]) for k in keys)
            pending.append((node, key, ts.open(_leaf_spec(path, name, meta),
                                               open=True, read=True,
                                               context=ctx)))
    reads = [(node, key, store.result().read()) for node, key, store
             in pending]
    for node, key, fut in reads:
        node[key] = np.asarray(fut.result())
    return _finish(root)


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A leaf as a tensor of its own dtype; bf16 (an ``ml_dtypes`` array,
    which ``torch.from_numpy`` refuses) through a uint16 view."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)
