"""K15 (``ops.fused_block``) on the CPU, where it runs its plain version,
against the JAX package's ``fused_transformer_block`` in interpret mode,
and ``mfvit_tpu_torch.tools.bench_block``.

Tolerances, at ``tests/test_fused_block.py``'s shapes (B=4, N=197, D=64, 4
heads), every bias non-zero:
- fp32 forward: rtol 1e-4 / atol 1e-4. The Pallas kernels' GELU is the
  A&S 7.1.26 polynomial (|error| about 1.5e-7 in erf), the port's the
  exact erf, and sums run in another order.
- the 13 gradients: max|diff| / max|ref| < 1e-2 per output, in fp32 and
  with bf16 x. JAX's backward is its K1 recompute, K7 and K5 Pallas
  kernels, which round h, qkv, dO, dS, dqkv, ga and gelu(a) to bf16 even
  for fp32 inputs (``mfvit_tpu/ops/fused_mlp.py:272-283``); the port's
  plain backward rounds there only in bf16. In fp32 the gap reads about
  4e-3; in bf16 both round at the same points, but a sum in another order
  can flip a rounding (one bf16 ulp is 3.9e-3 relative), the bar of
  ``tests/test_torch_port_train_ops.py``.
In bf16 the plain K15 is the plain K1 -> K2 chain, so its output and
gradients are equal bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.ops.fused_block import (
    fused_transformer_block as jax_fused_transformer_block)
from mfvit_tpu_torch.ops import fused_attn, fused_block, fused_mlp
from mfvit_tpu_torch.tools import bench_block

B, N, D, H = 4, 197, 64, 4
SCALE = (D // H) ** -0.5
NAMES = ("x", "ln1s", "ln1b", "wqkv", "bqkv", "wproj", "bproj", "ln2s",
         "ln2b", "w1", "b1", "w2", "b2")
MATRICES = ("wqkv", "wproj", "w1", "w2")


def _params(seed):
    """JAX-layout inputs ((in, out) weights), every bias non-zero."""
    rng = np.random.default_rng(seed)

    def r(*s, std=0.1):
        return (std * rng.standard_normal(s)).astype(np.float32)

    return dict(x=r(B, N, D, std=1.0), ln1s=1 + r(D), ln1b=r(D),
                wqkv=r(D, 3 * D), bqkv=r(3 * D), wproj=r(D, D), bproj=r(D),
                ln2s=1 + r(D), ln2b=r(D), w1=r(D, 4 * D), b1=r(4 * D),
                w2=r(4 * D, D), b2=r(D))


def _port_leaves(p, dtype=torch.float32):
    """The same values in the port's layout ((out, in) weights), as leaves
    that require grad; x in ``dtype``, the rest fp32."""
    out = []
    for k in NAMES:
        v = torch.from_numpy(p[k].T.copy() if k in MATRICES else p[k])
        out.append((v.to(dtype) if k == "x" else v).requires_grad_())
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k15_and_its_13_gradients_match_jax_interpret(dtype):
    p = _params(0)
    jdt = jnp.dtype(dtype)
    p["x"] = np.asarray(jnp.asarray(p["x"]).astype(jdt).astype(jnp.float32))
    g = np.random.default_rng(10).standard_normal((B, N, D)).astype(
        np.float32)

    def f(*a):
        return jax_fused_transformer_block(*a, H, SCALE, True)

    args = [jnp.asarray(p[k]) for k in NAMES]
    args[0] = args[0].astype(jdt)
    want, vjp = jax.vjp(f, *args)
    want_grads = vjp(jnp.asarray(g).astype(jdt))
    leaves = _port_leaves(p, getattr(torch, dtype))
    got = fused_block.fused_transformer_block(*leaves, H, SCALE)
    assert got.dtype == leaves[0].dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4)
    else:  # one rounding of the output: a flip is one ulp of it
        assert _rel(got.detach().float().numpy(), want) < 1e-2
    grads = torch.autograd.grad(got, leaves,
                                torch.from_numpy(g).to(got.dtype))
    for k, gp, gj in zip(NAMES, grads, want_grads):
        gj = np.asarray(jnp.asarray(gj).astype(jnp.float32))
        r = _rel(gp.float().numpy(), gj.T if k in MATRICES else gj)
        assert r < 1e-2, (k, r)


def test_bf16_plain_k15_is_the_k1_k2_chain_bit_for_bit():
    p = _params(2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, N, D)).astype(np.float32)).bfloat16()
    a = _port_leaves(p, torch.bfloat16)
    got = fused_block.fused_transformer_block(*a, H, SCALE)
    b = _port_leaves(p, torch.bfloat16)
    x2 = fused_attn.fused_attention_block(*b[:7], H, SCALE)
    want = fused_mlp.fused_mlp_block(x2, *b[7:])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.equal(got, fused_block.fused_transformer_block_plain(
        *[v.detach() for v in a], H, SCALE))
    for d1, d2, k in zip(torch.autograd.grad(got, a, g),
                         torch.autograd.grad(want, b, g), NAMES):
        assert d1.dtype == (torch.bfloat16 if k == "x" else torch.float32)
        assert torch.equal(d1, d2), k


def test_k15_refuses_nothing_on_the_cpu_but_counts_no_launch():
    from mfvit_tpu_torch import ops
    ops.reset_launch_counts()
    leaves = _port_leaves(_params(4))
    fused_block.fused_transformer_block(*leaves, H, SCALE,
                                        plain=True).sum().backward()
    assert all(v == 0 for v in ops.launch_counts().values())
    assert "fused_transformer_block" in ops.launch_counts()


def test_bench_block_runs_small_on_the_cpu(capsys):
    res = bench_block.main(["--device", "cpu", "--batch", "2", "--depth",
                            "2"])
    out = capsys.readouterr().out
    assert out.count("ms for 2 blocks") == 4
    (ms_pair, sum_pair), (ms_k15, sum_k15) = res["K1 -> K2"], res["K15"]
    assert ms_pair > 0 and ms_k15 > 0
    assert np.isfinite(sum_pair) and sum_pair == sum_k15


def test_bench_block_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_block.main(["--batch", "2", "--depth", "1"])
