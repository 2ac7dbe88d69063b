"""The port's two bf16 GEMM cores alone: C = epilogue(A . W^T + bias).

``gemm_sm90`` runs the warpgroup-MMA core of ``csrc/gemm_sm90.cuh`` (TMA
tile loads, ``wgmma.mma_async``), on which K1, K2 and K15 run their GEMMs;
``gemm_ln`` runs the WMMA core of ``csrc/gemm_ln.cuh`` that K3, K4, K9 and
the schedule variants run on (and K1 and K2 ran on before their redesign),
without its LayerNorm prologue. Both sum every output over k in ascending k16 steps and
round where gemm_ln's epilogues do, so ``chip_smoke.py`` can count the
outputs where they differ (whether a wgmma k16 step rounds as ``mma.sync``'s
does) and time them side by side. They replace no TPU kernel: no path of
the port calls them. CPU tensors take the plain version.

``epi``: "bias" (bf16(acc + b)), "gelu" (bf16(GELU_erf(acc + b))) or
"resid" (bf16(r + bf16(acc + b)), with ``resid`` (M, N) bf16).
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.ops import launch

LAUNCHES = {"gemm_sm90": 0, "gemm_ln": 0}
EPI = {"bias": 0, "gelu": 1, "resid": 2}


def gemm_plain(a, w, bias, epi: str = "bias", resid=None) -> torch.Tensor:
    """a (M, K), w (N, K), bias (N,) -> (M, N) in a's dtype, fp32 inside."""
    v = a.float() @ w.float().T + bias.float()
    if epi == "gelu":
        v = torch.nn.functional.gelu(v)
    elif epi == "resid":
        v = resid.float() + v.to(a.dtype).float()
    return v.to(a.dtype)


def _gemm(entry: str, a, w, bias, epi: str, resid):
    if epi not in EPI:
        raise ValueError(f"epi must be one of {sorted(EPI)}, got {epi!r}")
    if not a.is_cuda:
        return gemm_plain(a, w, bias, epi, resid)
    (M, K), N = a.shape, w.shape[0]
    if N % 128 or K % 64:
        raise ValueError(f"{entry} takes N % 128 == 0 and K % 64 == 0; got "
                         f"N={N}, K={K}")
    bf16 = torch.bfloat16
    launch.require(a, bf16, "a")
    launch.require(w, bf16, "w", (N, K))
    if epi == "resid":
        launch.require(resid, bf16, "resid", (M, N))
    out = torch.empty(M, N, dtype=bf16, device=a.device)
    launch.call(f"mfv_{entry}", a.device, a, w, launch.vec(bias, N, "bias"),
                resid if epi == "resid" else None, out, M, N, K, EPI[epi])
    LAUNCHES[entry] += 1
    return out


def gemm_sm90(a, w, bias, epi: str = "bias", resid=None) -> torch.Tensor:
    """The wgmma core (N % 128 == 0, K % 64 == 0 on the card)."""
    return _gemm("gemm_sm90", a, w, bias, epi, resid)


def gemm_ln(a, w, bias, epi: str = "bias", resid=None) -> torch.Tensor:
    """The WMMA core of K3 and K4 (N % 128 == 0, K % 64 == 0 on the
    card)."""
    return _gemm("gemm_ln", a, w, bias, epi, resid)
