"""Build and load the Hopper kernels in ``mfvit_tpu_torch/csrc``.

The kernels have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes``. The build happens on first use:
the library's file name carries a hash of the ``csrc`` sources, so an
edited source rebuilds and an unchanged one loads the library already
built. Output goes to ``build/mfvit_tpu_torch/`` beside the package, with
the compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) in ``build.log`` next to the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mfvit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
# name -> argtypes of the C entry points (each returns a cudaError_t as int)
SIGNATURES = {
    "mfv_fused_attention_block": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
    "mfv_fused_mlp_block": [_P] * 13 + [_I, _I, _I, _P],
    "mfv_fused_fusion_cls": [_P, _P, _I, _I, _I, _I, _F, _PP, _PP, _P, _P,
                             _P, _P, _P, _P],
}

_lib = None


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the mfvit_tpu_torch kernels")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmfvit_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their hash is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in sources() if p.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        Path(tmp).unlink(missing_ok=True)  # nvcc removes it on some failures
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.mfv_error_string.argtypes = [ctypes.c_int]
        cdll.mfv_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().mfv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
