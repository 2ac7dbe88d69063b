"""The attention schedule variants T1 (``attn_pairs``), T2 (``attn_rolling``)
and T5 (``staged_bwd``) and their tools on the CPU, where they run their
plain versions, against the JAX tools' own functions.

The JAX side is ``tools/bench_attn_pairs.py``, ``tools/bench_rolling.py``
and ``tools/bench_bwd_staged.py`` as they are, loaded by
``test_torch_port_variants._load_tool`` (the imports and the kernel and
wrapper ``def``s only, ``pallas_call`` in interpret mode). Inputs are
numpy-seeded (B=4, D=128, 4 heads of 32, every bias non-zero), the
weights transposed to the torch layout for the port.

Tolerances:
- T1 and T2 as T4 in ``test_torch_port_variants``: fp32 rtol/atol 1e-4;
  bf16 the branch error below ATTN_BF16_BAR, which the wrong versions of
  ``_attn_controls`` must fail on the same inputs.
- T5 in bf16: per output max|diff| / max|ref| < BF16_REL (1e-2), the bar
  of ``test_torch_port_train_ops`` for K5 against the Pallas backward: both
  round at the same points, but a sum in another order can flip a bf16
  rounding (one ulp is 3.9e-3 relative), which carries into what follows.
- T5 in fp32: the JAX tool rounds h, qkv, the weights, P, dO and dqkv to
  bf16 whatever its inputs' dtype (:65-105 there), so the port's fp32
  version, which rounds nowhere, is held to the tool by BF16_REL, and to
  JAX's fp32 reference backward ``_bwd_xla_reference``, the function it
  computes in fp32, at rtol 1e-4 / atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfvit_tpu.ops import fused_attn as jfa
from mfvit_tpu_torch import ops
from mfvit_tpu_torch.ops import attn_variants, fused_attn
from mfvit_tpu_torch.tools import (bench_attn_pairs, bench_bwd_staged,
                                   bench_rolling)
from test_torch_port_variants import (ATTN_BF16_BAR, ATTN_KEYS, B, D, H,
                                      SCALE, _attn_controls, _branch_err,
                                      _jax_args, _load_tool, _np, _params,
                                      _port_args)

BF16_REL = 1e-2
BWD_KEYS = ATTN_KEYS[:-1]  # bproj has no part in the backward
# the port's outputs (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj) by
# their place in the JAX tool's (dx, dwqkv, dbqkv, dwproj, dbproj, ds, db)
JAX_ORDER = (0, 3, 4, 5, 6, 1, 2)
TOOLS = (bench_attn_pairs, bench_rolling, bench_bwd_staged)


@pytest.fixture(scope="module")
def tools():
    return {**_load_tool("bench_attn_pairs.py",
                         {"_attn_pairs_kernel", "attn_pairs"}),
            **_load_tool("bench_rolling.py",
                         {"_attn_kernel_rolling", "attn_rolling"}),
            **_load_tool("bench_bwd_staged.py",
                         {"_staged_bwd_kernel", "staged_bwd"})}


FWD_CASES = {"attn_pairs": attn_variants.attn_pairs,
             "attn_rolling": attn_variants.attn_rolling}


@pytest.mark.parametrize("n", [50, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cb", [2, 4])
@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_forward_variant_matches_the_jax_tool(tools, name, cb, dtype, n):
    p = _params(n, seed=5)
    want = _np(tools[name](*_jax_args(p, ATTN_KEYS, jnp.dtype(dtype)), H,
                           SCALE, cb))
    a = _port_args(p, ATTN_KEYS, jnp.dtype(dtype))
    got = FWD_CASES[name](*a, H, SCALE, cb=cb)
    assert got.dtype == a[0].dtype and got.shape == a[0].shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        return
    x = a[0].float().numpy()
    assert _branch_err(got.float().numpy(), want, x) < ATTN_BF16_BAR
    for label, wrong in _attn_controls(*a).items():
        err = _branch_err(wrong.float().numpy(), want, x)
        assert err > ATTN_BF16_BAR, (label, err)


def _cotangent(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, n, D)).astype(np.float32)


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [50, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cb", [2, 4])
def test_staged_bwd_matches_the_jax_tool(tools, cb, dtype, n):
    p, g = _params(n, seed=6), _cotangent(n, 7)
    dt = jnp.dtype(dtype)
    want = tools["staged_bwd"](jnp.asarray(g).astype(dt),
                               *_jax_args(p, BWD_KEYS, dt), H, SCALE, cb)
    a = _port_args(p, BWD_KEYS, dt)
    gp = torch.from_numpy(np.array(_np(jnp.asarray(g).astype(dt)))).to(
        a[0].dtype)
    got = attn_variants.staged_bwd(gp, *a, H, SCALE, cb=cb)
    assert got[0].dtype == a[0].dtype
    got = [got[i].float().numpy() for i in JAX_ORDER]
    for i, (gv, w) in enumerate(zip(got, want)):
        w = _np(w).reshape(-1) if gv.ndim == 1 else _np(w)
        gv = gv.T if gv.ndim == 2 else gv
        assert _max_rel(gv, w) < BF16_REL, (i, _max_rel(gv, w))
    if dtype == "float32":
        ref = jfa._bwd_xla_reference(
            H, SCALE, False, (jnp.asarray(p["x"]),
                              *(jnp.asarray(p[k]) for k in ATTN_KEYS)),
            jnp.asarray(g))
        port = attn_variants.staged_bwd(torch.from_numpy(g), *a, H, SCALE,
                                        cb=cb)
        for gv, w in zip(port, ref):  # the same order, the JAX layout
            gv = gv.numpy()
            np.testing.assert_allclose(gv.T if gv.ndim == 2 else gv, _np(w),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [50, 197])
def test_bf16_plain_variants_are_the_plain_k1_and_k5(n):
    p = _params(n, seed=8)
    a = _port_args(p, ATTN_KEYS, jnp.bfloat16)
    k1 = fused_attn.fused_attention_block(*a, H, SCALE)
    assert torch.equal(attn_variants.attn_pairs(*a, H, SCALE, cb=2), k1)
    assert torch.equal(attn_variants.attn_rolling(*a, H, SCALE, cb=4), k1)
    g = torch.from_numpy(_cotangent(n, 9)).bfloat16()
    k5 = fused_attn.fused_attention_block_bwd_plain(g, *a[:6], H, SCALE)
    for got, want in zip(attn_variants.staged_bwd(g, *a[:6], H, SCALE, cb=4),
                         k5):
        assert torch.equal(got, want)


def test_the_attention_variants_refuse_what_their_kernels_do_not_take():
    a = _port_args(_params(50, seed=3), ATTN_KEYS, jnp.bfloat16)
    g = torch.zeros_like(a[0])
    calls = {
        "must be even": [lambda: attn_variants.attn_pairs(*a, H, SCALE,
                                                          cb=1)],
        "must divide B": [
            lambda: attn_variants.attn_pairs(*a, H, SCALE, cb=8),
            lambda: attn_variants.attn_rolling(*a, H, SCALE, cb=3),
            lambda: attn_variants.staged_bwd(g, *a[:6], H, SCALE, cb=3)],
        "must have x's shape": [lambda: attn_variants.staged_bwd(
            g[:, :10], *a[:6], H, SCALE)]}
    for match, fns in calls.items():
        for call in fns:
            with pytest.raises(ValueError, match=match):
                call()
    x = torch.zeros(2, 209, 384, dtype=torch.bfloat16)
    w = [torch.zeros(384), torch.zeros(384), torch.zeros(1152, 384),
         torch.zeros(1152), torch.zeros(384, 384), torch.zeros(384)]
    for call in (lambda: attn_variants.attn_pairs(x, *w, 3, SCALE, cb=2),
                 lambda: attn_variants.attn_rolling(x, *w, 3, SCALE, cb=2),
                 lambda: attn_variants.staged_bwd(x, x, *w[:5], 3, SCALE)):
        with pytest.raises(ValueError, match="N <= 208"):
            call()
    x = torch.zeros(2, 257, 384, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N <= 256"):
        attn_variants.attn_rolling(x, *w, 12, SCALE, cb=2)


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_the_forward_variants_are_forward_only(name):
    t = list(_port_args(_params(50, seed=4), ATTN_KEYS, jnp.float32))
    t[3] = t[3].clone().requires_grad_()  # a weight
    with pytest.raises(RuntimeError, match="forward only"):
        FWD_CASES[name](*t, H, SCALE, cb=2)
    with torch.no_grad():
        out = FWD_CASES[name](*t, H, SCALE, cb=2)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("tool", [bench_attn_pairs, bench_rolling])
def test_the_forward_tools_run_small_on_the_cpu_in_the_jax_order(tool, batch,
                                                                 capsys):
    ops.reset_launch_counts()
    res = tool.main(["--device", "cpu", "--batch", str(batch), "--depth",
                     "2"])
    lines = capsys.readouterr().out.splitlines()[1:]
    names = [n for n, _, _ in tool.chains()]
    assert [ln.split(":")[0] for ln in lines] == names
    assert names[0] == names[-1]
    # a cb that does not divide the batch prints as skipped
    skipped = [n for n, cb, _ in tool.chains() if cb and batch % cb]
    assert [ln.split(":")[0] for ln in lines if "skipped" in ln] == skipped
    assert len(res) == len(set(names)) - len(skipped)
    sums = {v[1] for v in res.values()}
    assert len(sums) == 1 and np.isfinite(sums.pop())
    assert all(v == 0 for v in ops.launch_counts().values())


def test_the_bwd_tool_runs_small_on_the_cpu_in_the_jax_order(capsys):
    ops.reset_launch_counts()
    res, errs = bench_bwd_staged.main(["--device", "cpu", "--batch", "2",
                                       "--depth", "2"])
    lines = capsys.readouterr().out.splitlines()[1:]
    names = [n for n, _, _ in bench_bwd_staged.chains()]
    assert [ln.split(":")[0] for ln in lines[:len(names)]] == names
    assert lines[len(names) - 2] == "staged cb=4: skipped, cb must divide B=2"
    assert set(res) == {"current cb=2", "staged cb=2"}
    sums = {v[1] for v in res.values()}
    assert len(sums) == 1 and np.isfinite(sums.pop())
    assert [ln.split(" ")[0] for ln in lines[len(names):]] == [
        "dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "ds", "db"]
    assert list(errs.values()) == [0.0] * 7
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("tool", TOOLS)
def test_the_tools_reexport_the_jax_tools_names(tool):
    name = tool.__all__[0]
    assert name == {bench_attn_pairs: "attn_pairs",
                    bench_rolling: "attn_rolling",
                    bench_bwd_staged: "staged_bwd"}[tool]
    assert getattr(tool, name) is getattr(attn_variants, name)


def test_the_tools_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    for tool in TOOLS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--batch", "2", "--depth", "1"])
