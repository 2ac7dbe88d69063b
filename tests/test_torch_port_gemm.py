"""The two GEMM cores alone (``ops.gemm``: the wgmma core K15 runs on and
the WMMA core of K1-K4) on the CPU, where both run their plain version,
against the same function in JAX on the same numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-5 in fp32 (the sums run in another order);
in bf16 the plain version rounds where the kernels' epilogues do (the
product plus bias once, GELU's or the residual's sum once), which the test
spells out in numpy."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu_torch import ops
from mfvit_tpu_torch.ops import gemm

M, N, K = 40, 256, 128


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32),
            (0.1 * rng.standard_normal(N)).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


def _jax(a, w, b, epi, r):
    v = jnp.dot(jnp.asarray(a), jnp.asarray(w).T,
                precision=jax.lax.Precision.HIGHEST) + b
    if epi == "gelu":
        return jax.nn.gelu(v, approximate=False)
    if epi == "resid":
        return r + v
    return v


@pytest.mark.parametrize("core", ["gemm_sm90", "gemm_ln"])
@pytest.mark.parametrize("epi", ["bias", "gelu", "resid"])
def test_gemm_cores_take_their_plain_version_on_the_cpu(core, epi):
    a, w, b, r = _inputs(0)
    ops.reset_launch_counts()
    got = getattr(gemm, core)(*(torch.from_numpy(v) for v in (a, w, b)), epi,
                              torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax(a, w, b, epi, r)),
                               rtol=1e-5, atol=1e-5)
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("epi", ["bias", "gelu", "resid"])
def test_bf16_plain_gemm_rounds_where_the_epilogues_do(epi):
    a, w, b, r = (torch.from_numpy(v) for v in _inputs(1))
    a, w, r = a.bfloat16(), w.bfloat16(), r.bfloat16()
    got = gemm.gemm_plain(a, w, b, epi, r)
    v = a.double().numpy() @ w.double().numpy().T
    v = torch.from_numpy(v).float() + b
    if epi == "gelu":
        v = torch.nn.functional.gelu(v)
    if epi == "resid":
        v = r.float() + v.bfloat16().float()
    assert got.dtype == torch.bfloat16
    # fp32 sums in another order: a rare flip of the one rounding
    diff = (got.float() - v.bfloat16().float()).abs()
    assert (diff > 0).float().mean() < 0.02
    assert diff.max() <= 2 ** -6 * v.abs().max()


def test_gemm_refuses_an_unknown_epilogue():
    a, w, b, _ = (torch.from_numpy(v) for v in _inputs(2))
    with pytest.raises(ValueError, match="epi"):
        gemm.gemm_sm90(a, w, b, "relu")
