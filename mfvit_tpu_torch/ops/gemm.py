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

``gemm_mn`` and ``gemm_bwd`` do the same for the backward products of K5
and K7: the MN-major forms of the wgmma core (csrc/gemm_bwd_sm90.cuh) and
the WMMA GEMMs of csrc/gemm_bwd.cuh that K5's and K7's former chains run.
``form``: "nn" (a (M, K) . b (K, N), bf16 out), "nn_f32" (the same in
fp32) or "tn" (a (K, M)^T . b (K, N) in fp32 and the column sums of a,
through S slices of kc rows, each summed alone and the partials reduced in
slice order, as ``launch.k_split`` gives them).
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.ops import launch

LAUNCHES = {"gemm_sm90": 0, "gemm_ln": 0, "gemm_mn": 0, "gemm_bwd": 0}
EPI = {"bias": 0, "gelu": 1, "resid": 2}
FORMS = {"nn": 0, "nn_f32": 1, "tn": 2}


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


def gemm_bwd_plain(a, b, form: str = "nn"):
    """The plain version of ``gemm_mn`` and ``gemm_bwd``: "nn" a . b in a's
    dtype, "nn_f32" the same in fp32, "tn" (a^T . b, a.sum(0)) in fp32;
    fp32 sums inside."""
    if form == "tn":
        return a.float().T @ b.float(), a.float().sum(0)
    out = a.float() @ b.float()
    return out if form == "nn_f32" else out.to(a.dtype)


def _bwd_gemm(entry: str, a, b, form: str, S: int, kc: int):
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}, got {form!r}")
    if not a.is_cuda:
        return gemm_bwd_plain(a, b, form)
    f32, dev = torch.float32, a.device
    launch.require(a, torch.bfloat16, "a")
    launch.require(b, torch.bfloat16, "b")
    if form == "tn":
        (K, M), N = a.shape, b.shape[1]
        if b.shape[0] != K or M % 128 or N % 128 or kc % 32 or not (
                0 <= (S - 1) * kc < K <= S * kc):
            raise ValueError(f"{entry} (tn) takes a (K, M), b (K, N), M and N "
                             f"% 128 == 0 and S slices of kc % 32 == 0 rows "
                             f"covering K; got a {tuple(a.shape)}, b "
                             f"{tuple(b.shape)}, S={S}, kc={kc}")
        out, bias = torch.empty(M, N, dtype=f32, device=dev), \
            torch.empty(M, dtype=f32, device=dev)
        part = torch.empty(S * (M * N + M), dtype=f32, device=dev)
    else:
        (M, K), N = a.shape, b.shape[1]
        if b.shape[0] != K or N % 128 or K % 64:
            raise ValueError(f"{entry} ({form}) takes a (M, K), b (K, N), N % "
                             f"128 == 0 and K % 64 == 0; got a "
                             f"{tuple(a.shape)}, b {tuple(b.shape)}")
        S, kc, bias, part = 1, K, None, None
        out = torch.empty(M, N, dtype=f32 if form == "nn_f32" else a.dtype,
                          device=dev)
    launch.call(f"mfv_{entry}", dev, a, b, out, bias, part, M, N, K, S, kc,
                FORMS[form])
    LAUNCHES[entry] += 1
    return (out, bias) if form == "tn" else out


def gemm_mn(a, b, form: str = "nn", S: int = 1, kc: int = 0):
    """The MN-major forms of the wgmma core (K5's and K7's backward
    products)."""
    return _bwd_gemm("gemm_mn", a, b, form, S, kc)


def gemm_bwd(a, b, form: str = "nn", S: int = 1, kc: int = 0):
    """gemm_bwd.cuh's WMMA GEMMs, which K5's and K7's former chains run."""
    return _bwd_gemm("gemm_bwd", a, b, form, S, kc)
