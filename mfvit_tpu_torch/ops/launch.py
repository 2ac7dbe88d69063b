"""What every kernel wrapper does around its C entry point: check the
tensors it passes, keep fp32 copies of the small vectors alive across the
call, launch on PyTorch's current stream (no synchronisation) and raise on
the CUDA error the entry point returns."""
from __future__ import annotations

import torch

from mfvit_tpu_torch.ops.build import check, lib


def require(t: torch.Tensor, dtype: torch.dtype, name: str,
            shape: tuple | None = None) -> None:
    """The kernels take contiguous, 16-byte aligned CUDA tensors of one
    dtype (and shape, where given); anything else raises."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def call(entry: str, device: torch.device, *args) -> None:
    """Call a C entry point. Tensors in ``args`` go as device pointers (they
    stay referenced until the call returns), ``None`` as a null pointer,
    everything else as is; the stream is appended."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    check(getattr(lib(), entry)(*ptrs, stream), entry)


def k_split(K: int, tiles: int, step: int, target: int = 264) -> tuple:
    """(S, kc): S slices of kc rows each for a reduction over K rows with
    ``tiles`` output tiles, so that about ``target`` blocks (two per SM of
    an H100) run at once. kc is a multiple of ``step`` and no slice is
    empty; the kernels take both numbers as they are and only check them."""
    s = max(1, min(-(-target // tiles), -(-K // step)))
    kc = -(-(-(-K // s)) // step) * step
    return -(-K // kc), kc


def vec(v: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A bias or LayerNorm vector as the kernels take it: (n,) fp32,
    contiguous, on the device."""
    v = v.float().contiguous()
    require(v, torch.float32, name, (n,))
    return v
