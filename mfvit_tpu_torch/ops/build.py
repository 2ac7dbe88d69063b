"""Build and load the Hopper kernels in ``mfvit_tpu_torch/csrc``.

The kernels have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes``: one ``nvcc -c`` per ``.cu`` source,
all started together, then one link. The build happens on first use:
the library's file name carries a hash of the ``csrc`` sources, so an
edited source rebuilds and an unchanged one loads the library already
built. Output goes to ``build/mfvit_tpu_torch/`` beside the package, with
the compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) in ``build.log`` next to the library. ``BUILD`` records what the
first ``lib()`` call of the process cost: ``built`` is 1 where it ran
``nvcc``, ``build_s`` the seconds ``build()`` took (hashing the sources,
and compiling where it did), ``load_s`` the seconds loading the library
and binding its entry points took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mfvit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
# name -> argtypes of the C entry points (each returns a cudaError_t as int)
SIGNATURES = {
    "mfv_fused_attention_block": [_P] * 10 + [_I, _I, _I, _I, _F, _P],
    "mfv_fused_attention_block_wmma": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
    "mfv_fused_attention_block_large": [_P] * 10 + [_I, _I, _I, _I, _F, _P],
    "mfv_fused_attention_block_large_wmma": [_P] * 11 + [_I, _I, _I, _I, _F,
                                                         _P],
    "mfv_fused_mlp_block": [_P] * 10 + [_I] * 4 + [_P],
    "mfv_fused_mlp_block_final_ln": [_P] * 13 + [_I] * 4 + [_P],
    "mfv_fused_mlp_block_final_ln_wmma": [_P] * 13 + [_I, _I, _I, _P],
    "mfv_fused_mlp_block_wmma": [_P] * 10 + [_I, _I, _I, _P],
    "mfv_fused_transformer_block": [_P] * 16 + [_I] * 6 + [_F, _P],
    "mfv_fused_fusion_cls": [_P, _P, _I, _I, _I, _I, _F, _PP, _PP, _P, _P,
                             _P, _P, _P],
    "mfv_fused_fusion_cls_kv": [_P, _P, _I, _I, _I, _I, _F, _PP, _PP, _P,
                                _P, _P, _P, _P, _P],
    "mfv_fused_attention_block_bwd": [_P] * 22 + [_I] * 4 + [_F] + [_I] * 6
                                     + [_P],
    "mfv_fused_attention_block_bwd_wmma": [_P] * 22 + [_I] * 4 + [_F]
                                          + [_I] * 6 + [_P],
    "mfv_fused_mlp_block_bwd": [_P] * 20 + [_I] * 7 + [_P],
    "mfv_fused_mlp_block_bwd_wmma": [_P] * 20 + [_I] * 7 + [_P],
    "mfv_fused_attention_block_i8": [_P] * 14 + [_I] * 4 + [_F, _P],
    "mfv_fused_attention_block_i8_route": [_P] * 14 + [_I] * 4 + [_F, _I,
                                                                 _P],
    "mfv_fused_attention_block_i8_mma": [_P] * 14 + [_I] * 4 + [_F, _P],
    "mfv_fused_mlp_block_i8": [_P] * 14 + [_I] * 3 + [_P],
    "mfv_fused_mlp_block_i8_route": [_P] * 14 + [_I] * 4 + [_P],
    "mfv_fused_mlp_block_i8_mma": [_P] * 14 + [_I] * 3 + [_P],
    "mfv_mhsa_packed": [_P, _P] + [_I] * 6 + [_F, _P],
    "mfv_mhsa": [_P] * 4 + [_I] * 6 + [_F, _P],
    "mfv_mhsa_packed_t": [_P, _P] + [_I] * 6 + [_F, _P],
    "mfv_mlp3d": [_P] * 8 + [_I] * 6 + [_P],
    "mfv_mlp3d_staged": [_P] * 8 + [_I] * 6 + [_P],
    "mfv_mlp3d_wmma": [_P] * 8 + [_I] * 6 + [_P],
    "mfv_mlp3d_staged_wmma": [_P] * 8 + [_I] * 5 + [_P],
    "mfv_mlp_pipe": [_P] * 8 + [_I] * 6 + [_P],
    "mfv_mlp_pipe_mma": [_P] * 8 + [_I] * 5 + [_P],
    "mfv_attn_staged": [_P] * 10 + [_I] * 5 + [_F, _P],
    "mfv_attn_staged_wmma": [_P] * 11 + [_I] * 5 + [_F, _P],
    "mfv_attn_pairs": [_P] * 10 + [_I] * 5 + [_F, _P],
    "mfv_attn_pairs_wmma": [_P] * 11 + [_I] * 5 + [_F, _P],
    "mfv_attn_rolling": [_P] * 10 + [_I] * 5 + [_F, _P],
    "mfv_attn_rolling_wmma": [_P] * 11 + [_I] * 5 + [_F, _P],
    "mfv_staged_bwd": [_P] * 22 + [_I] * 4 + [_F] + [_I] * 7 + [_P],
    "mfv_staged_bwd_former": [_P] * 22 + [_I] * 4 + [_F] + [_I] * 7 + [_P],
    "mfv_gemm_sm90": [_P] * 5 + [_I] * 4 + [_P],
    "mfv_gemm_ln": [_P] * 5 + [_I] * 4 + [_P],
    "mfv_gemm_mn": [_P] * 5 + [_I] * 6 + [_P],
    "mfv_gemm_bwd": [_P] * 5 + [_I] * 6 + [_P],
}

_lib = None
BUILD = {"built": 0, "build_s": 0.0, "load_s": 0.0}


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
    # compile into a fresh directory and rename the library: a concurrent
    # or interrupted build never leaves a half-written one under its name
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    cus = [p for p in sources() if p.suffix == ".cu"]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(work / f"{p.stem}.o")]
            for p in cus]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    # -ldl: gemm_sm90.cuh looks up the driver's cuTensorMapEncodeTiled
    link = [nvcc, "-shared", "-o", str(work / "lib.so"),
            *[c[-1] for c in cmds], "-ldl"]
    if all(rc == 0 for _, _, rc in logs):
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, res.stdout + res.stderr, res.returncode))
    (BUILD_DIR / "build.log").write_text("".join(
        " ".join(c) + "\n" + text for c, text, _ in logs))
    failed = [(c, text, rc) for c, text, rc in logs if rc != 0]
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        c, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{text}")
    os.replace(work / "lib.so", out)
    shutil.rmtree(work, ignore_errors=True)
    BUILD["built"] = 1
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        path = build()
        t1 = time.perf_counter()
        cdll = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.mfv_error_string.argtypes = [ctypes.c_int]
        cdll.mfv_error_string.restype = ctypes.c_char_p
        _lib = cdll
        BUILD.update(build_s=t1 - t0, load_s=time.perf_counter() - t1)
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().mfv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
