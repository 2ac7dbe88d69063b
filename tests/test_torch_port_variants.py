"""The schedule variants T6 (``mlp3d``), T7 (``mlp3d_staged``), T3
(``mlp_pipe``) and T4 (``attn_staged``) and their tools on the CPU, where
they run their plain versions, against the JAX tools' own functions.

The JAX side is ``tools/bench_mlp3d.py`` and ``tools/bench_pipelined.py``
as they are: importing either runs its B=512 benchmark, so ``_load_tool``
parses the file with ``ast``, keeps only its imports and the ``def``s of
the kernels and their wrappers, executes those, and hands them a ``pl``
whose ``pallas_call`` is ``functools.partial(pl.pallas_call,
interpret=True)``. Inputs are numpy-seeded (B=4, D=128, 4 heads of 32,
every bias non-zero, b2 included), the weights transposed to the torch
layout for the port.

Tolerances:
- fp32: rtol 1e-4 / atol 1e-4. The tools' GELU is the A&S 7.1.26
  polynomial (|error| about 1.5e-7 in erf), the port's the exact erf, and
  sums run in another order (readings up to 3.5e-7 relative).
- bf16: the branch error ||got - want|| / ||want - x|| below a bar that
  wrong versions of the function must fail on the same inputs. Both sides
  round at the same points, but the fp32 sums run in another order (and
  the GELUs differ as above), so a value near a bf16 tie rounds the other
  way; a flipped k or v of the attention reaches every query of its head.
  Over seeds 0, 1, 5 and 9 at N=50 and 197 the readings were up to 3.4e-4
  (MLP) and 1.9e-3 (attention), 0 in some cases. MLP_BF16_BAR 1e-3: the
  hidden kept in fp32 reads about 4e-3, b2 rounded to bf16 1.6e-3 and
  more. ATTN_BF16_BAR 3e-3: the biases rounded to bf16 read 7e-3 and
  more, p not rounded for PV 4.6e-3 and more.
In bf16 the plain variants are the plain K1 and K2 bit for bit."""
import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mfvit_tpu_torch import ops
from mfvit_tpu_torch.nn.layers import layer_norm, linear_f32
from mfvit_tpu_torch.ops import attn_variants, fused_attn, fused_mlp
from mfvit_tpu_torch.ops import mlp_variants
from mfvit_tpu_torch.tools import bench_mlp3d, bench_pipelined

B, D, H = 4, 128, 4
SCALE = (D // H) ** -0.5
MLP_BF16_BAR = 1e-3
ATTN_BF16_BAR = 3e-3
ATTN_KEYS = ("ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
MLP_KEYS = ("ln_s", "ln_b", "w1", "b1", "w2", "b2")
MATRICES = ("wqkv", "wproj", "w1", "w2")


class _InterpretPallas:
    """``pl`` with every ``pallas_call`` in interpret mode."""
    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load_tool(name: str, names: set) -> dict:
    path = str(TOOLS / name)
    tree = ast.parse(open(path).read(), path)
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef) and n.name in names)]
    assert {n.name for n in keep if isinstance(n, ast.FunctionDef)} == names
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns["pl"] = _InterpretPallas()
    return ns


@pytest.fixture(scope="module")
def tools():
    m3 = _load_tool("bench_mlp3d.py", {
        "_mlp3d_kernel", "mlp3d", "_mlp3d_staged_kernel", "mlp3d_staged"})
    pp = _load_tool("bench_pipelined.py", {
        "_mlp_kernel_pipe", "mlp_pipe", "_attn_kernel_staged", "attn_staged"})
    return {**m3, **pp}


def _params(n: int, seed: int = 0) -> dict:
    """JAX-layout inputs ((in, out) weights), every bias non-zero."""
    rng = np.random.default_rng(seed)

    def r(*s, std=0.1):
        return (std * rng.standard_normal(s)).astype(np.float32)

    return dict(x=r(B, n, D, std=1.0), ln_s=1 + r(D), ln_b=r(D),
                wqkv=r(D, 3 * D, std=0.05), bqkv=r(3 * D),
                wproj=r(D, D, std=0.05), bproj=r(D),
                w1=r(D, 4 * D, std=0.05), b1=r(4 * D),
                w2=r(4 * D, D, std=0.05), b2=r(D))


def _jax_args(p, keys, dtype):
    return (jnp.asarray(p["x"]).astype(dtype),
            *(jnp.asarray(p[k]) for k in keys))


def _port_args(p, keys, dtype):
    """The same values in the port's layout; x rounded as JAX rounds it."""
    x = np.array(jnp.asarray(p["x"]).astype(dtype).astype(jnp.float32))
    return (torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name)),
            *(torch.from_numpy(np.ascontiguousarray(
                p[k].T if k in MATRICES else p[k])) for k in keys))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _branch_err(got, want, x) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - x))


# (name, JAX tool call, port call) of the MLP variants, on the same inputs
MLP_CASES = {
    "mlp3d flat": (lambda t, a: t["mlp3d"](*a, 2, True),
                   lambda a: mlp_variants.mlp3d(*a, cb=2, flat=True)),
    "mlp3d loop": (lambda t, a: t["mlp3d"](*a, 2, False),
                   lambda a: mlp_variants.mlp3d(*a, cb=2, flat=False)),
    "mlp3d_staged": (lambda t, a: t["mlp3d_staged"](*a, 2),
                     lambda a: mlp_variants.mlp3d_staged(*a, cb=2)),
    # M = 200 and 788 rows: JAX pads to a multiple of 128, the port masks
    "mlp_pipe": (lambda t, a: t["mlp_pipe"](*a, 2, 128),
                 lambda a: mlp_variants.mlp_pipe(*a, splits=2, tm=128)),
}


def _mlp_controls(x, ln_s, ln_b, w1, b1, w2, b2) -> dict:
    """Wrong versions of K2's function in bf16 that the bar must fail."""
    a = F.gelu(linear_f32(layer_norm(x, ln_s, ln_b, 1e-6), w1, b1))
    return {"hidden in fp32": x + linear_f32(a, w2.to(x.dtype).float(),
                                             b2).to(x.dtype),
            "b2 rounded to bf16": x + linear_f32(
                a.to(x.dtype), w2, b2.to(x.dtype).float()).to(x.dtype)}


@pytest.mark.parametrize("n", [50, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_variant_matches_the_jax_tool(tools, case, dtype, n):
    p = _params(n)
    jax_call, port_call = MLP_CASES[case]
    want = _np(jax_call(tools, _jax_args(p, MLP_KEYS, jnp.dtype(dtype))))
    a = _port_args(p, MLP_KEYS, jnp.dtype(dtype))
    got = port_call(a)
    assert got.dtype == a[0].dtype and got.shape == a[0].shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    x = a[0].float().numpy()
    assert _branch_err(got, want, x) < MLP_BF16_BAR
    for name, wrong in _mlp_controls(*a).items():
        err = _branch_err(wrong.float().numpy(), want, x)
        assert err > MLP_BF16_BAR, (name, err)


def _attn_controls(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj) -> dict:
    """Wrong versions of K1's function in bf16 that the bar must fail."""
    dt = x.dtype
    rounded = fused_attn.fused_attention_block_plain(
        x, ln_s, ln_b, wqkv, bqkv.to(dt).float(), wproj, bproj.to(dt).float(),
        H, SCALE)
    qkv = linear_f32(layer_norm(x, ln_s, ln_b, 1e-6), wqkv, bqkv).to(dt)
    q, k, v = (t.reshape(*x.shape[:2], H, -1).transpose(1, 2).float()
               for t in qkv.split(D, dim=-1))
    s = (q * SCALE).to(dt).float() @ k.transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e @ v) / e.sum(-1, keepdim=True)  # p never rounded
    o = o.transpose(1, 2).reshape(x.shape).to(dt)
    return {"biases rounded to bf16": rounded,
            "p not rounded for PV": x + linear_f32(o, wproj, bproj).to(dt)}


@pytest.mark.parametrize("n", [50, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_staged_matches_the_jax_tool(tools, dtype, n):
    p = _params(n, seed=1)
    want = _np(tools["attn_staged"](
        *_jax_args(p, ATTN_KEYS, jnp.dtype(dtype)), H, SCALE, 2))
    a = _port_args(p, ATTN_KEYS, jnp.dtype(dtype))
    got = attn_variants.attn_staged(*a, H, SCALE, cb=2)
    assert got.dtype == a[0].dtype and got.shape == a[0].shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        return
    x = a[0].float().numpy()
    assert _branch_err(got.float().numpy(), want, x) < ATTN_BF16_BAR
    for name, wrong in _attn_controls(*a).items():
        err = _branch_err(wrong.float().numpy(), want, x)
        assert err > ATTN_BF16_BAR, (name, err)


@pytest.mark.parametrize("n", [50, 197])
def test_bf16_plain_variants_are_the_plain_k1_and_k2(n):
    p = _params(n, seed=2)
    m = _port_args(p, MLP_KEYS, jnp.bfloat16)
    k2 = fused_mlp.fused_mlp_block(*m)
    for got in (mlp_variants.mlp3d(*m, cb=2, flat=True),
                mlp_variants.mlp3d(*m, cb=4, flat=False),
                mlp_variants.mlp3d_staged(*m, cb=1),
                mlp_variants.mlp_pipe(*m, splits=1, tm=128)):
        assert torch.equal(got, k2)
    a = _port_args(p, ATTN_KEYS, jnp.bfloat16)
    assert torch.equal(attn_variants.attn_staged(*a, H, SCALE, cb=4),
                       fused_attn.fused_attention_block(*a, H, SCALE))


def test_the_variants_refuse_what_their_kernels_do_not_take():
    m = _port_args(_params(50, seed=3), MLP_KEYS, jnp.bfloat16)
    a = _port_args(_params(50, seed=3), ATTN_KEYS, jnp.bfloat16)
    for call in (lambda: mlp_variants.mlp3d(*m, cb=3),
                 lambda: mlp_variants.mlp3d_staged(*m, cb=8),
                 lambda: attn_variants.attn_staged(*a, H, SCALE, cb=3)):
        with pytest.raises(ValueError, match="must divide B"):
            call()
    with pytest.raises(ValueError, match="multiple of splits"):
        mlp_variants.mlp_pipe(*m, splits=3, tm=64)
    for splits, tm in ((4, 32), (2, 64), (8, 64)):
        with pytest.raises(ValueError, match="registers"):
            mlp_variants.mlp_pipe(*m, splits=splits, tm=tm)

    def zeros(d, hd=None):
        shapes = ((d,), (d,), (hd, d), (hd,), (d, hd), (d,)) if hd else (
            (d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,))
        return [torch.zeros(*s) for s in shapes]

    x = torch.zeros(2, 50, 768, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        mlp_variants.mlp3d(x, *zeros(768, 3072), cb=2)
    x = torch.zeros(2, 50, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="registers"):
        mlp_variants.mlp_pipe(x, *zeros(512, 2048), splits=2, tm=128)
    for n, heads, limit in ((257, 12, "N <= 256"), (209, 3, "N <= 208")):
        x = torch.zeros(2, n, 384, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=limit):
            attn_variants.attn_staged(x, *zeros(384), heads, SCALE, cb=2)


@pytest.mark.parametrize("case", ["mlp3d", "mlp3d_staged", "mlp_pipe",
                                  "attn_staged"])
def test_the_variants_are_forward_only(case):
    m = _port_args(_params(50, seed=4), MLP_KEYS, jnp.float32)
    a = _port_args(_params(50, seed=4), ATTN_KEYS, jnp.float32)
    call = {"mlp3d": lambda t: mlp_variants.mlp3d(*t, cb=2),
            "mlp3d_staged": lambda t: mlp_variants.mlp3d_staged(*t, cb=2),
            "mlp_pipe": lambda t: mlp_variants.mlp_pipe(*t),
            "attn_staged": lambda t: attn_variants.attn_staged(
                *t, H, SCALE, cb=2)}[case]
    t = list(a if case == "attn_staged" else m)
    t[3] = t[3].clone().requires_grad_()  # a weight
    with pytest.raises(RuntimeError, match="forward only"):
        call(t)
    with torch.no_grad():
        out = call(t)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("tool", [bench_mlp3d, bench_pipelined])
def test_the_tools_run_small_on_the_cpu_in_the_jax_order(tool, capsys):
    ops.reset_launch_counts()
    res = tool.main(["--device", "cpu", "--batch", "2", "--depth", "2"])
    lines = capsys.readouterr().out.splitlines()[1:]
    names = [n for n, _, _ in tool.chains()]
    assert [ln.split(":")[0] for ln in lines] == names
    assert names[0] == names[-1] and names[0].startswith("baseline")
    ran = [ln for ln in lines if "skipped" not in ln]
    # every cb that divides B=2 ran: the baseline twice and each cb=2 chain
    assert len(ran) == len(lines) - sum("cb=4" in n or "cb=8" in n
                                        for n in names)
    sums = {v[1] for v in res.values()}
    assert len(sums) == 1 and np.isfinite(sums.pop())
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("tool", [bench_mlp3d, bench_pipelined])
def test_the_tools_reexport_the_jax_tools_names(tool):
    assert tool.__all__[:2] == (["mlp3d", "mlp3d_staged"]
                                if tool is bench_mlp3d
                                else ["mlp_pipe", "attn_staged"])
    for name in tool.__all__[:2]:
        assert callable(getattr(tool, name))


def test_the_tools_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    for tool in (bench_mlp3d, bench_pipelined):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--batch", "2", "--depth", "1"])
