"""Kernel-against-plain tests for K1-K5, K7, K9-K15, the schedule
variants T1-T7 and the two GEMM cores (``ops.gemm``) on the card, K9
and K11 against the chains they ran before (bit for bit), and the MoCo
step, the GPT fusion step and the ViT + CNN head, kernel path against
plain path. They need CUDA, nvcc
and an sm_90a GPU, so they carry the ``cuda`` marker and skip elsewhere;
on the card run ``python -m pytest tests/test_torch_port_cuda.py``
(``chip_smoke.py`` makes the same comparisons at serving shapes).

Each kernel takes bf16 inputs; its plain version runs in fp32 on the same
bf16-rounded inputs. Bar: max|diff| / max|ref| < 2e-2, the bf16 bar of
``tools/drive_verify.py`` for Pallas against XLA."""
import pytest
import torch

from mfvit_tpu_torch import ops
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ops import (attention, attn_variants, fused_attn,
                                 fused_block, fused_fusion, fused_int8,
                                 fused_mlp, gemm, mlp_variants, quant)

pytestmark = pytest.mark.cuda
REL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, *shape, std=1.0):
    return torch.randn(*shape, generator=g) * std


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _block(dev, B, N, D):
    g = torch.Generator().manual_seed(0)
    t = dict(x=_rnd(g, B, N, D).bfloat16(), ln_s=1 + _rnd(g, D, std=0.1),
             ln_b=_rnd(g, D, std=0.1),
             wqkv=_rnd(g, 3 * D, D, std=D ** -0.5).bfloat16(),
             bqkv=_rnd(g, 3 * D, std=0.1),
             wproj=_rnd(g, D, D, std=D ** -0.5).bfloat16(),
             bproj=_rnd(g, D, std=0.1),
             w1=_rnd(g, 4 * D, D, std=D ** -0.5).bfloat16(),
             b1=_rnd(g, 4 * D, std=0.1),
             w2=_rnd(g, D, 4 * D, std=(4 * D) ** -0.5).bfloat16(),
             b2=_rnd(g, D, std=0.1), fs=1 + _rnd(g, D, std=0.1),
             fb=_rnd(g, D, std=0.1))
    return {k: v.to(dev) for k, v in t.items()}


ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")


def _f32(t, keys):
    return [t[k].float() for k in keys]


@pytest.mark.parametrize("B,N,D,H", [(2, 197, 384, 12), (3, 197, 384, 6),
                                     (2, 197, 768, 12), (2, 50, 256, 2)])
def test_kernels_match_plain(dev, B, N, D, H):
    t = _block(dev, B, N, D)
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    got = fused_attn.fused_attention_block(*[t[k] for k in ATTN], H, scale)
    ref = fused_attn.fused_attention_block_plain(*_f32(t, ATTN), H, scale)
    assert _rel(got, ref) < REL
    got = fused_mlp.fused_mlp_block(*[t[k] for k in MLP])
    ref = fused_mlp.fused_mlp_block_plain(*_f32(t, MLP))
    assert _rel(got, ref) < REL
    got = fused_mlp.fused_mlp_block_final_ln(*[t[k] for k in MLP], t["fs"],
                                             t["fb"])
    ref = fused_mlp.fused_mlp_block_final_ln_plain(*_f32(t, MLP), t["fs"],
                                                   t["fb"])
    assert _rel(got, ref) < REL
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "fused_attention_block": 1, "fused_attention_block_large": 0,
        "fused_mlp_block": 1,
        "fused_mlp_block_final_ln": 1, "fused_fusion_cls": 0,
        "fused_attention_block_bwd": 0, "fused_mlp_block_bwd": 0,
        "fused_attention_block_i8": 0, "fused_mlp_block_i8": 0,
        "mhsa_packed": 0, "mhsa": 0, "mhsa_packed_t": 0,
        "fused_transformer_block": 0, "mlp3d": 0, "mlp3d_staged": 0,
        "mlp_pipe": 0, "attn_staged": 0, "attn_pairs": 0, "attn_rolling": 0,
        "staged_bwd": 0, "gemm_sm90": 0, "gemm_ln": 0, "gemm_mn": 0,
        "gemm_bwd": 0}


@pytest.mark.parametrize("B,heads", [(8, 3), (5, 3), (3, 6)])
def test_fusion_kernel_matches_plain(dev, B, heads):
    g = torch.Generator().manual_seed(1)
    N, D = 197, 384
    tc, te = (_rnd(g, B, N, D).bfloat16().to(dev) for _ in range(2))
    flat = []
    for _ in range(2):
        flat += [1 + _rnd(g, D, std=0.1), _rnd(g, D, std=0.1),
                 _rnd(g, D, D, std=0.05).bfloat16(),
                 _rnd(g, 2 * D, D, std=0.05).bfloat16(),
                 _rnd(g, D, D, std=0.05).bfloat16(), _rnd(g, D, std=0.1),
                 1 + _rnd(g, D, std=0.1), _rnd(g, D, std=0.1)]
    flat = [f.to(dev) for f in flat]
    got = fused_fusion.fused_fusion_cls(tc, te, flat, heads)
    ref = fused_fusion.fused_fusion_cls_plain(
        tc.float(), te.float(), [f.float() for f in flat], heads)
    for a, b in zip(got, ref):
        assert _rel(a, b) < REL


@pytest.mark.parametrize("B,N,D,H", [(2, 197, 384, 12), (3, 197, 384, 6),
                                     (2, 197, 768, 12), (2, 50, 256, 2),
                                     (2, 100, 512, 4), (1, 256, 384, 6)])
def test_backward_kernels_match_plain(dev, B, N, D, H):
    """K5 and K7 against their plain backward in fp32 on the same bf16
    values, all seven outputs."""
    t = _block(dev, B, N, D)
    g = _rnd(torch.Generator().manual_seed(3), B, N, D).bfloat16().to(dev)
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    a = [g] + [t[k] for k in ATTN[:-1]]
    got = fused_attn.fused_attention_block_bwd(*a, H, scale)
    ref = fused_attn.fused_attention_block_bwd_plain(
        *[v.float() for v in a], H, scale)
    assert all(_rel(x, y) < REL for x, y in zip(got, ref))
    m = [g] + [t[k] for k in MLP[:-1]]
    got = fused_mlp.fused_mlp_block_bwd(*m)
    ref = fused_mlp.fused_mlp_block_bwd_plain(*[v.float() for v in m])
    assert all(_rel(x, y) < REL for x, y in zip(got, ref))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["fused_attention_block_bwd"],
            counts["fused_mlp_block_bwd"]) == (1, 1)


def test_vit_training_gets_fp32_grads_from_the_kernels(dev):
    """A requires_grad forward through a ViT on the card: every block and
    patch-embedding parameter gets a gradient, in fp32, and the backward ran K5 and K7 once per
    block (the kernels' outputs once had no grad_fn; the patch embedding's
    fp32-output GEMM once had no derivative)."""
    cfg = vit.get_config("vit_small")
    m = vit.ViT(cfg, 3, device=dev)
    imgs = torch.randn(2, 224, 224, 3, device=dev).bfloat16()
    ops.reset_launch_counts()
    m(imgs).sum().backward()
    torch.cuda.synchronize()
    for name, p in [*m.blocks.named_parameters(),
                    *m.patch_embed.named_parameters()]:
        assert p.grad is not None, name
        assert p.grad.dtype == torch.float32, name
        assert p.grad.abs().sum() > 0, name
    counts = ops.launch_counts()
    assert counts["fused_attention_block_bwd"] == cfg.depth
    assert counts["fused_mlp_block_bwd"] == cfg.depth


def test_cuda_tensors_never_take_the_plain_version(dev):
    t = _block(dev, 1, 197, 384)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attn.fused_attention_block(*_f32(t, ATTN), 12, 32 ** -0.5)
    with pytest.raises(ValueError, match="N <= 256"):
        x = torch.zeros(1, 300, 384, dtype=torch.bfloat16, device=dev)
        fused_attn.fused_attention_block(x, *[t[k] for k in ATTN[1:]], 12,
                                         32 ** -0.5)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attn.fused_attention_block_large(*_f32(t, ATTN), 12,
                                               32 ** -0.5)


def test_long_sequences_need_k9(dev):
    """A vit_small forward at 384 px (577 tokens) runs K9 in every block
    and K1 in none; its backward is the fp32 recompute (no K5)."""
    m = vit.ViT(vit.get_config("vit_small", 384), 3, device=dev)
    ops.reset_launch_counts()
    m(torch.randn(1, 384, 384, 3, device=dev).bfloat16()).sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fused_attention_block_large"] == 12
    assert counts["fused_attention_block"] == 0
    assert counts["fused_attention_block_bwd"] == 0
    assert counts["fused_mlp_block_bwd"] == 12
    for name, p in m.blocks.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name


@pytest.mark.parametrize("B,N,D,H", [(2, 577, 384, 12), (2, 1025, 384, 6),
                                     (2, 577, 768, 12), (2, 300, 384, 3),
                                     (2, 257, 384, 12)])
def test_k9_matches_plain(dev, B, N, D, H):
    """K9 at vit_small@384, vit_small_ori@512, vit_base@384, head_dim 128
    and N=257 (the first length past K1), against its plain version in
    fp32 on the same bf16 values."""
    t = _block(dev, B, N, D)
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    got = fused_attn.fused_attention_block_large(*[t[k] for k in ATTN], H,
                                                 scale)
    torch.cuda.synchronize()
    ref = fused_attn.fused_attention_block_plain(*_f32(t, ATTN), H, scale)
    assert _rel(got, ref) < REL
    assert ops.launch_counts()["fused_attention_block_large"] == 1


@pytest.mark.parametrize("B,N,D,H", [(2, 197, 384, 12), (3, 50, 256, 2)])
def test_k9_equals_k1_up_to_256_tokens(dev, B, N, D, H):
    """Up to 256 tokens K9's attention core does K1's arithmetic in K1's
    order, key for key: the two agree bit for bit."""
    t = _block(dev, B, N, D)
    scale = (D // H) ** -0.5
    a = [t[k] for k in ATTN]
    assert torch.equal(fused_attn.fused_attention_block_large(*a, H, scale),
                       fused_attn.fused_attention_block(*a, H, scale))


@pytest.mark.parametrize("B,N,D,H", [(2, 577, 384, 12), (2, 1025, 384, 6),
                                     (2, 577, 768, 12), (2, 300, 384, 3),
                                     (2, 577, 384, 3), (2, 257, 384, 12),
                                     (2, 1025, 384, 12)])
def test_k9_equals_its_former_chain(dev, B, N, D, H):
    """K9 (K1's LN pass and wgmma GEMMs around attn_long_async.cu's core)
    against the chain it ran before (``fused_attention_block_large_wmma``:
    gemm_ln's WMMA GEMMs around attn_long.cuh's core): every rounding point
    and sum order kept, so the two agree bit for bit, at head_dim 32, 64
    and 128 and N from 257 to 1025."""
    t = _block(dev, B, N, D)
    scale = (D // H) ** -0.5
    a = [t[k] for k in ATTN]
    assert torch.equal(fused_attn.fused_attention_block_large(*a, H, scale),
                       fused_attn.fused_attention_block_large_wmma(*a, H,
                                                                   scale))


@pytest.mark.parametrize("B,N,D,w1_scale,b1", [
    (8, 197, 384, 1.0, None), (3, 50, 384, 1.0, None),
    (2, 577, 384, 1.0, None), (2, 197, 768, 1.0, None),
    (2, 197, 128, 1.0, None), (2, 197, 512, 1.0, None),
    (2, 197, 384, 0.05, None), (2, 197, 384, 1e-4, 2.0)])
def test_k11_equals_its_former_chain(dev, B, N, D, w1_scale, b1):
    """K11 (the one-launch int8 wgmma tail at D of 128-384 from
    I8T_TAIL_ROWS rows on, four launches on the int8 wgmma core below them
    and at 512 and 768) against the chain it ran before (``fused_mlp_block_i8_mma``:
    gemm_i8.cuh's mma.sync GEMMs): exact int32 sums and the same epilogue
    functions, so the two agree bit for bit; one launch counted a call.
    Both routes are also forced (``fused_mlp_block_i8_route``) at the
    tail's widths. The last two inputs drive the tail's first pass through
    its other branches: rows whose max of fc1 lies below 0.5 and near ties
    (b1 = 2, fc1 tiny)."""
    t = _block(dev, B, N, D)
    t["w1"] = t["w1"] * w1_scale
    if b1 is not None:
        t["b1"] = torch.full_like(t["b1"], b1)
    _, mlp = _i8_args(t)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = fused_int8.fused_mlp_block_i8(*mlp)
        former = fused_int8.fused_mlp_block_i8_mma(*mlp)
        assert torch.equal(got, former)
        assert ops.launch_counts()["fused_mlp_block_i8"] == 1
        for tail in ((True, False) if D in fused_int8.I8T_WIDTHS else ()):
            assert torch.equal(
                fused_int8.fused_mlp_block_i8_route(*mlp, tail), former)
    assert ops.launch_counts()["fused_mlp_block_i8"] == 1


@pytest.mark.parametrize("B,N,D,H", [
    (8, 197, 384, 12), (128, 197, 384, 12), (2, 197, 768, 12),
    (3, 50, 384, 12), (2, 256, 384, 12), (2, 257, 384, 12),
    (2, 577, 384, 6), (2, 300, 384, 3), (2, 197, 256, 2)])
def test_k10_equals_its_former_chain(dev, B, N, D, H):
    """K10 (three launches on the quantizing int8 GEMMs from
    I8Q_FUSED_WORK token rows x width on, five with quant_rows before the
    plain int8 wgmma core below; the asynchronous cores with an fp32 output)
    against the chain it ran before (``fused_attention_block_i8_mma``:
    gemm_i8.cuh's mma.sync GEMMs, attn_core.cuh's or attn_long.cuh's core):
    the same quantizer, exact int32 sums, the same epilogue functions and
    the former cores' rounding points and sum orders, so the two agree bit
    for bit; one launch counted a call. Both routes are also forced
    (``fused_attention_block_i8_route``) at every shape."""
    t = _block(dev, B, N, D)
    attn, _ = _i8_args(t)
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    with torch.no_grad():
        got = fused_int8.fused_attention_block_i8(*attn, H, scale)
        former = fused_int8.fused_attention_block_i8_mma(*attn, H, scale)
        assert torch.equal(got, former)
        assert ops.launch_counts()["fused_attention_block_i8"] == 1
        for fused in (True, False):
            assert torch.equal(fused_int8.fused_attention_block_i8_route(
                *attn, H, scale, fused), former)
    assert ops.launch_counts()["fused_attention_block_i8"] == 1


def test_k9_backward_on_the_card_is_the_fp32_recompute(dev):
    """K9's Function backward on CUDA against the same fp32 recompute on
    the CPU for the same inputs: fp32 sums in another order, so weight
    gradients within rel 1e-4 and dx (rounded to bf16) within one bf16 ulp
    of its largest value."""
    B, N, D, H = 2, 577, 384, 12
    t = _block(dev, B, N, D)
    g = _rnd(torch.Generator().manual_seed(5), B, N, D).bfloat16()
    scale = (D // H) ** -0.5
    leaves = [t["x"]] + [t[k].float() for k in ATTN[1:]]
    leaves = [v.detach().clone().requires_grad_() for v in leaves]
    out = fused_attn.fused_attention_block_large(*leaves, H, scale)
    got = torch.autograd.grad(out, leaves, g.to(dev))
    cpu = [v.detach().cpu() for v in leaves]
    want = fused_attn.fused_attention_block_bwd_f32(g, *cpu[:-1], H, scale)
    assert got[0].dtype == torch.bfloat16
    assert _rel(got[0].cpu(), want[0]) <= 2 ** -8
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and _rel(a.cpu(), b) < 1e-4


def _i8_args(t):
    """K10's and K11's arguments from one block's inputs: the bf16 weights
    quantized per output channel, the vectors fp32."""
    q = {k: fused_int8.quantize_weight_cols(t[k]) for k in
         ("wqkv", "wproj", "w1", "w2")}
    attn = (t["x"], t["ln_s"], t["ln_b"], *q["wqkv"], t["bqkv"], *q["wproj"],
            t["bproj"])
    mlp = (t["x"], t["ln_s"], t["ln_b"], *q["w1"], t["b1"], *q["w2"],
           t["b2"])
    return attn, mlp


@pytest.mark.parametrize("B,N,D,H", [(2, 197, 384, 12), (3, 50, 384, 12),
                                     (2, 197, 768, 12), (2, 50, 768, 12),
                                     (2, 197, 256, 2), (2, 50, 256, 2)])
def test_int8_kernels_match_plain(dev, B, N, D, H):
    """K10 and K11 against their plain versions in fp32 on the same bf16
    x and int8 weights, at head_dim 32, 64 and 128 and N 50 and 197."""
    attn, mlp = _i8_args(_block(dev, B, N, D))
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    with torch.no_grad():
        got = fused_int8.fused_attention_block_i8(*attn, H, scale)
        ref = fused_int8.fused_attention_block_i8_plain(
            attn[0].float(), *attn[1:], H, scale)
        assert _rel(got, ref) < REL
        got = fused_int8.fused_mlp_block_i8(*mlp)
        ref = fused_int8.fused_mlp_block_i8_plain(mlp[0].float(), *mlp[1:])
        assert _rel(got, ref) < REL
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["fused_attention_block_i8"],
            counts["fused_mlp_block_i8"]) == (1, 1)


def test_k10_at_577_tokens_holds_its_branch_bar(dev):
    """K10 past 256 tokens (vit_small_ori@384: 6 heads, the W8A8 route
    there) on attn_long.cuh: against the plain version in fp32 (rel <
    2e-2), and its branch (out - x) against the plain version in bf16,
    ||kernel - plain|| / ||plain - x|| < 6e-3, the bar of chip_smoke.py."""
    attn, _ = _i8_args(_block(dev, 2, 577, 384))
    scale = 64 ** -0.5
    with torch.no_grad():
        got = fused_int8.fused_attention_block_i8(*attn, 6, scale)
        ref = fused_int8.fused_attention_block_i8_plain(
            attn[0].float(), *attn[1:], 6, scale)
        assert _rel(got, ref) < REL
        plain = fused_int8.fused_attention_block_i8(*attn, 6, scale,
                                                    plain=True)
    x = attn[0].float()
    branch = ((got.float() - plain.float()).norm()
              / (plain.float() - x).norm()).item()
    assert branch < 6e-3


def test_cuda_tensors_never_take_the_plain_int8_version(dev):
    attn, mlp = _i8_args(_block(dev, 1, 197, 384))
    with torch.no_grad():
        with pytest.raises(ValueError, match="bfloat16"):
            fused_int8.fused_attention_block_i8(attn[0].float(), *attn[1:],
                                                12, 32 ** -0.5)
        with pytest.raises(ValueError, match="bfloat16"):
            fused_int8.fused_mlp_block_i8(mlp[0].float(), *mlp[1:])
        with pytest.raises(ValueError, match="head_dim"):
            fused_int8.fused_attention_block_i8(*attn, 8, 48 ** -0.5)


def test_int8_quantizers_on_the_card_match_the_cpu(dev):
    """quantize_weight_cols and quant_rows give the same codes and scales
    on a CUDA tensor as on the CPU (where they are JAX's bit for bit), and
    the scales are those the kernels compute: amax / 127 by IEEE
    division."""
    g = torch.Generator().manual_seed(4)
    w = _rnd(g, 1152, 384, std=0.05)
    w[7] = 0.0
    h = _rnd(g, 394, 1536)
    for fn, a in ((fused_int8.quantize_weight_cols, w),
                  (fused_int8.quant_rows, h)):
        (q, s), (qd, sd) = fn(a), fn(a.to(dev))
        assert torch.equal(q, qd.cpu()) and torch.equal(s, sd.cpu())


def _last_held(dh: int) -> int:
    """The longest N whose scores K12-K14's plan holds in shared memory;
    one more computes them three times."""
    n = 1
    while attention._plan(n + 1, dh, True).hold:
        n += 1
    return n


# K12-K14: (B, N, D, heads) at vit_small, vit_small_ori, vit_base, head_dim
# 128, N=50 and past 256 tokens (N=577, 1025); then the edges: one token,
# head_dim 128 in the shortest key tile, 256 and 257 tokens; one and two
# 8-key tiles (N=16, 17), the last 8-key tile of N=197 full and one past it
# (208, 209); one unit of seven query tiles and the first length that
# takes two (112, 113); a batch whose units wrap the persistent grid
# several times (B=67, 12 heads); head_dim 64 and 128 at N=577; and the
# longest N that holds its scores in shared memory and the next one up
# (head_dim 32: 376, 377)
MHSA_SHAPES = [(8, 197, 384, 12), (8, 197, 384, 6), (4, 197, 768, 12),
               (2, 300, 384, 3), (8, 50, 384, 12), (2, 577, 384, 6),
               (2, 1025, 384, 6), (3, 1, 384, 12), (2, 50, 256, 2),
               (2, 256, 384, 6), (2, 257, 384, 6),
               (2, 16, 384, 12), (2, 17, 384, 12), (2, 208, 384, 12),
               (2, 209, 384, 12), (2, 112, 384, 12), (2, 113, 384, 12),
               (67, 197, 384, 12), (2, 577, 384, 3)]
MHSA_SHAPES += [(2, n, 384, 12) for n in (_last_held(32), _last_held(32) + 1)]


def _packed(dev, B, N, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return _rnd(g, B, N, 3 * D).bfloat16().to(dev)


@pytest.mark.parametrize("B,N,D,H", MHSA_SHAPES)
def test_mhsa_kernels_match_plain(dev, B, N, D, H):
    """K12, K13 and K14 against their plain versions in fp32 on the same
    bf16 values, each in its own layout, and against their plain versions
    in bf16, which round where the kernels do (||diff|| / ||plain|| <
    4e-4, the bar of chip_smoke.py's MHSA_BAR); one launch each."""
    qkv = _packed(dev, B, N, D)
    scale = (D // H) ** -0.5
    q, k, v = (t.contiguous() for t in attention._split(qkv, H, False))
    qkv_t = qkv.transpose(1, 2).contiguous()
    ops.reset_launch_counts()
    with torch.no_grad():
        for got, ref, plain in (
                (attention.mhsa_packed(qkv, H, scale),
                 attention.mhsa_packed_plain(qkv.float(), H, scale),
                 attention.mhsa_packed_plain(qkv, H, scale)),
                (attention.mhsa(q, k, v),
                 attention.mhsa_plain(q.float(), k.float(), v.float(),
                                      (D // H) ** -0.5),
                 attention.mhsa_plain(q, k, v, (D // H) ** -0.5)),
                (attention.mhsa_packed_t(qkv_t, H, scale),
                 attention.mhsa_packed_t_plain(qkv_t.float(), H, scale),
                 attention.mhsa_packed_t_plain(qkv_t, H, scale))):
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == ref.shape
            assert _rel(got, ref) < REL
            diff = (got.float() - plain.float()).norm()
            assert diff / plain.float().norm() < 4e-4
    counts = ops.launch_counts()
    assert (counts["mhsa_packed"], counts["mhsa"],
            counts["mhsa_packed_t"]) == (1, 1, 1)


@pytest.mark.parametrize("B,N,D,H", MHSA_SHAPES)
def test_k12_equals_k14(dev, B, N, D, H):
    """K12 and K14 share one core: the same bits on the same values after
    the layout change."""
    qkv = _packed(dev, B, N, D, seed=1)
    scale = (D // H) ** -0.5
    with torch.no_grad():
        a = attention.mhsa_packed(qkv, H, scale)
        b = attention.mhsa_packed_t(qkv.transpose(1, 2).contiguous(), H,
                                    scale)
    assert torch.equal(a, b.transpose(1, 2))


def test_mhsa_backward_on_the_card_is_the_fp32_recompute(dev):
    """The Functions' backward on CUDA tensors against the same fp32
    recompute on the CPU: fp32 sums in another order, so within one bf16
    ulp of the largest gradient."""
    B, N, D, H = 2, 197, 384, 12
    scale = 32 ** -0.5
    qkv = _packed(dev, B, N, D, seed=2)
    cot = _rnd(torch.Generator().manual_seed(3), B, N, D).bfloat16()
    x = qkv.detach().clone().requires_grad_()
    got = torch.autograd.grad(attention.mhsa_packed(x, H, scale), x,
                              cot.to(dev))[0]
    xc = qkv.cpu().requires_grad_()
    want = torch.autograd.grad(attention.mhsa_packed(xc, H, scale), xc,
                               cot)[0]
    assert got.dtype == torch.bfloat16 and _rel(got.cpu(), want) <= 2 ** -8
    xt = qkv.transpose(1, 2).contiguous().requires_grad_()
    got_t = torch.autograd.grad(attention.mhsa_packed_t(xt, H, scale), xt,
                                cot.to(dev).transpose(1, 2))[0]
    assert _rel(got_t.transpose(1, 2).cpu(), want) <= 2 ** -8
    q, k, v = (t.contiguous().requires_grad_()
               for t in attention._split(qkv, H, False))
    got3 = torch.autograd.grad(attention.mhsa(q, k, v), (q, k, v),
                               attention._to_heads(cot.to(dev), H, False))
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    want3 = torch.autograd.grad(attention.mhsa(qc, kc, vc), (qc, kc, vc),
                                attention._to_heads(cot, H, False))
    for a, b in zip(got3, want3):
        assert a.dtype == torch.bfloat16 and _rel(a.cpu(), b) <= 2 ** -8


def test_cuda_tensors_never_take_the_plain_mhsa(dev):
    qkv = _packed(dev, 1, 197, 384)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.mhsa_packed(qkv.float(), 12, 0.2)
    with pytest.raises(ValueError, match="head_dim"):
        attention.mhsa_packed(qkv, 8, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.mhsa_packed_t(qkv.transpose(1, 2), 12, 0.2)
    q = torch.zeros(1, 2, 9, 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attention.mhsa(q, q, q)


def test_quantized_linear_refuses_requires_grad_on_the_card(dev):
    """A quantized linear is inference only on the card too; under no_grad
    its torch._int_mm product equals the CPU's float64 one."""
    g = torch.Generator().manual_seed(6)
    q, s = fused_int8.quantize_weight_cols(_rnd(g, 1152, 384, std=0.05))
    x = _rnd(g, 4, 197, 384).bfloat16()
    xd = x.to(dev).requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        quant.quantized_linear(q.to(dev), s.to(dev), xd)
    with torch.no_grad():
        got = quant.quantized_linear(q.to(dev), s.to(dev), xd, s.to(dev))
        want = quant.quantized_linear(q, s, x, s)
    assert torch.equal(got.cpu(), want)


def test_quantized_vit_runs_k12_in_every_block(dev):
    """A vit_small forward after quantize_vit_params runs K12 once per block
    and no other kernel, at 224 and 384 px."""
    for img in (224, 384):
        m = vit.quantize_vit_params(
            vit.ViT(vit.get_config("vit_small", img), 3, device=dev))
        ops.reset_launch_counts()
        with torch.no_grad():
            out = m(torch.randn(2, img, img, 3, device=dev).bfloat16())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts.pop("mhsa_packed") == 12
        assert not any(counts.values()) and out.isfinite().all()


# chip_smoke.py's HALVES_SHAPES: K15's, a partial last row tile, the block
# tail's other widths, a vit_base block (K2's three-launch route), and the
# shapes where an attention block walks several pairs of few query tiles
# and a GEMM block several tiles of more K slices than its ring holds
HALVES = [(8, 197, 384, 12), (8, 197, 384, 6), (8, 50, 384, 12),
          (8, 197, 384, 3), (3, 197, 384, 12), (4, 197, 128, 4),
          (4, 197, 256, 4), (4, 197, 512, 8), (2, 197, 768, 12),
          (64, 50, 384, 12), (16, 197, 768, 12)]


@pytest.mark.parametrize("B,N,D,H", HALVES)
def test_k1_k2_equal_their_former_chains_and_hold_their_plain_versions(
        dev, B, N, D, H):
    """K1 and K2 against the chains they ran before their redesign (the
    check-only WMMA chains: the same rounding points and the same order of
    every fp32 sum, so equal bit for bit) and against their plain fp32
    versions (rel < 2e-2); one call launches its own kernel once."""
    t = _block(dev, B, N, D)
    scale = (D // H) ** -0.5
    a, m = [t[k] for k in ATTN], [t[k] for k in MLP]
    ops.reset_launch_counts()
    with torch.no_grad():
        k1 = fused_attn.fused_attention_block(*a, H, scale)
        k2 = fused_mlp.fused_mlp_block(*m)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "fused_attention_block": 1, "fused_mlp_block": 1}
    with torch.no_grad():
        assert torch.equal(k1, fused_attn.fused_attention_block_wmma(
            *a, H, scale))
        assert torch.equal(k2, fused_mlp.fused_mlp_block_wmma(*m))
        assert _rel(k1, fused_attn.fused_attention_block_plain(
            *_f32(t, ATTN), H, scale)) < REL
        assert _rel(k2, fused_mlp.fused_mlp_block_plain(*_f32(t, MLP))) < REL


def test_k1_k2_refuse_widths_they_do_not_take(dev):
    """Widths past the block tail's other than 768 raise on the card, as
    does a hidden width that is no multiple of 128."""
    t = _block(dev, 1, 50, 640)
    with pytest.raises(ValueError, match="D of 128"):
        fused_attn.fused_attention_block(*[t[k] for k in ATTN], 10,
                                         64 ** -0.5)
    with pytest.raises(ValueError, match="K2"):
        fused_mlp.fused_mlp_block(*[t[k] for k in MLP])
    t = _block(dev, 1, 50, 384)
    m = [t[k] for k in MLP]
    with pytest.raises(ValueError, match="K2"):
        fused_mlp.fused_mlp_block(*m[:3], m[3][:1500], m[4][:1500],
                                  m[5][:, :1500], m[6])


@pytest.mark.parametrize("B,N,D", [(8, 197, 384), (16, 197, 768)])
def test_k3_equals_its_former_chain_and_holds_its_plain_version(dev, B, N,
                                                                D):
    """K3 (the block tail with its final-LayerNorm epilogue at vit_small;
    the GEMM core and the row LayerNorm at vit_base) against the WMMA chain
    it ran before (the same rounding points and the same order of every
    fp32 sum: equal bit for bit) and against its plain fp32 version (rel <
    2e-2); one call launches K3 once."""
    t = _block(dev, B, N, D)
    m, fin = [t[k] for k in MLP], (t["fs"], t["fb"])
    ops.reset_launch_counts()
    with torch.no_grad():
        got = fused_mlp.fused_mlp_block_final_ln(*m, *fin)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "fused_mlp_block_final_ln": 1}
    with torch.no_grad():
        assert torch.equal(got, fused_mlp.fused_mlp_block_final_ln_wmma(
            *m, *fin))
        assert _rel(got, fused_mlp.fused_mlp_block_final_ln_plain(
            *_f32(t, MLP), *fin)) < REL


# chip_smoke.K4_FORMER_BAR: K4 against its former design (same rounding
# points, fp32 sums in other orders)
K4_FORMER_BAR = 2e-4


@pytest.mark.parametrize("B,N,D,heads", [(3, 197, 384, 3), (256, 197, 384, 3),
                                         (3, 197, 768, 3), (256, 197, 768, 3),
                                         (64, 577, 384, 3), (3, 50, 768, 12)])
def test_k4_holds_its_former_design_and_its_plain_version(dev, B, N, D,
                                                          heads):
    """K4 (three launches on the absorbed form, no (B*N, 2D) scratch) at
    vit_small's and vit_base's fusion heads (3 heads, of 128 and of 256),
    at 384 px (N=577) and at 12 heads of 64, within K4_FORMER_BAR of the
    design it ran before (k and v of every row in fp32) and within rel
    2e-2 of its plain fp32 version; one call launches K4 once; u built
    from W_v in place of W_k fails the bar."""
    g = torch.Generator().manual_seed(2)
    tc, te = (_rnd(g, B, N, D).bfloat16().to(dev) for _ in range(2))
    flat = []
    for _ in range(2):
        flat += [1 + _rnd(g, D, std=0.1), _rnd(g, D, std=0.1),
                 _rnd(g, D, D, std=D ** -0.5).bfloat16(),
                 _rnd(g, 2 * D, D, std=D ** -0.5).bfloat16(),
                 _rnd(g, D, D, std=D ** -0.5).bfloat16(), _rnd(g, D, std=0.1),
                 1 + _rnd(g, D, std=0.1), _rnd(g, D, std=0.1)]
    flat = [f.to(dev) for f in flat]
    ops.reset_launch_counts()
    with torch.no_grad():
        got = torch.cat(fused_fusion.fused_fusion_cls(tc, te, flat, heads))
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "fused_fusion_cls": 1}
    former = torch.cat(fused_fusion.fused_fusion_cls_kv(tc, te, flat, heads))
    assert _rel(got, former) < K4_FORMER_BAR
    assert _rel(got, torch.cat(fused_fusion.fused_fusion_cls_plain(
        tc.float(), te.float(), [f.float() for f in flat], heads))) < REL
    swapped = list(flat)
    for d in (0, 8):
        swapped[d + 3] = torch.cat([flat[d + 3][D:]] * 2).contiguous()
    assert _rel(torch.cat(fused_fusion.fused_fusion_cls(tc, te, swapped,
                                                        heads)),
                former) >= K4_FORMER_BAR


K15_ARGS = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "ln_s",
            "ln_b", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("B,N,D,H", [(8, 197, 384, 12), (8, 197, 384, 6),
                                     (8, 50, 384, 12), (3, 197, 384, 3),
                                     (2, 197, 256, 2), (2, 100, 512, 8),
                                     (2, 197, 128, 4)])
def test_k15_equals_the_k1_k2_chain_and_holds_its_plain_version(dev, B, N,
                                                                 D, H):
    """K15 against the K1 -> K2 kernel chain on the same bf16 inputs (the
    same rounding points and the same order of every fp32 sum: equal bit
    for bit), against its plain fp32 version (rel < 2e-2), and its 13
    gradients (K1 recompute, K7, K5) against the plain fp32 backward."""
    t = _block(dev, B, N, D)
    scale = (D // H) ** -0.5
    a = [t[k] for k in K15_ARGS]
    ops.reset_launch_counts()
    with torch.no_grad():
        got = fused_block.fused_transformer_block(*a, H, scale)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop("fused_transformer_block") == 1
    assert not any(counts.values())
    with torch.no_grad():
        chain = fused_mlp.fused_mlp_block(
            fused_attn.fused_attention_block(*a[:7], H, scale), *a[7:])
        ref = fused_block.fused_transformer_block_plain(
            *[v.float() for v in a], H, scale)
    assert torch.equal(got, chain)
    assert _rel(got, ref) < REL
    leaves = [v.detach().clone().requires_grad_() for v in a]
    g = _rnd(torch.Generator().manual_seed(4), B, N, D).bfloat16().to(dev)
    ops.reset_launch_counts()
    grads = torch.autograd.grad(
        fused_block.fused_transformer_block(*leaves, H, scale), leaves, g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "fused_transformer_block": 1, "fused_attention_block": 1,
        "fused_mlp_block_bwd": 1, "fused_attention_block_bwd": 1}
    leaves32 = [v.detach().float().requires_grad_() for v in a]
    want = torch.autograd.grad(fused_block.fused_transformer_block(
        *leaves32, H, scale, plain=True), leaves32, g.float())
    for d, w in zip(grads, want):
        assert _rel(d, w) < REL


def test_k15_refuses_what_it_does_not_take(dev):
    t = _block(dev, 1, 197, 768)
    with pytest.raises(ValueError, match="D <= 512"):
        fused_block.fused_transformer_block(*[t[k] for k in K15_ARGS], 12,
                                            64 ** -0.5)
    t = _block(dev, 1, 300, 384)
    with pytest.raises(ValueError, match="N <= 256"):
        fused_block.fused_transformer_block(*[t[k] for k in K15_ARGS], 12,
                                            32 ** -0.5)
    t = _block(dev, 1, 197, 384)
    a = [t[k] for k in K15_ARGS]
    with pytest.raises(ValueError, match="bfloat16"):
        fused_block.fused_transformer_block(a[0].float(), *a[1:], 12,
                                            32 ** -0.5)


@pytest.mark.parametrize("M,N,K,epi", [(1576, 1152, 384, "bias"),
                                       (1576, 1536, 384, "gelu"),
                                       (1576, 384, 1536, "bias"),
                                       (300, 384, 1536, "resid"),
                                       (100, 128, 64, "bias"),
                                       (12608, 3072, 768, "gelu"),
                                       (12608, 768, 3072, "resid")])
def test_gemm_sm90_equals_gemm_ln_and_holds_its_plain_version(dev, M, N, K,
                                                              epi):
    """The wgmma core K15 runs on against the WMMA core of K1-K4 on the
    same bf16 inputs (every sum in ascending k16 steps, the same epilogue
    rounding: equal bit for bit), and within rel 2e-2 of the plain fp32
    version; one launch each."""
    g = torch.Generator().manual_seed(5)
    a = _rnd(g, M, K).bfloat16().to(dev)
    w = _rnd(g, N, K, std=K ** -0.5).bfloat16().to(dev)
    b = _rnd(g, N, std=0.1).to(dev)
    r = _rnd(g, M, N).bfloat16().to(dev)
    ops.reset_launch_counts()
    got = gemm.gemm_sm90(a, w, b, epi, r)
    ref = gemm.gemm_ln(a, w, b, epi, r)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "gemm_sm90": 1, "gemm_ln": 1}
    assert torch.equal(got, ref)
    assert _rel(got, gemm.gemm_plain(a.float(), w.float(), b, epi,
                                     r.float())) < REL


# the MLP variants at every schedule argument their tools sweep
MLP_VARIANTS = {
    **{f"mlp3d flat cb={cb}": (lambda a, cb=cb: mlp_variants.mlp3d(
        *a, cb=cb, flat=True), "mlp3d") for cb in (1, 2, 4)},
    **{f"mlp3d loop cb={cb}": (lambda a, cb=cb: mlp_variants.mlp3d(
        *a, cb=cb, flat=False), "mlp3d") for cb in (1, 2, 4)},
    **{f"mlp3d_staged cb={cb}": (lambda a, cb=cb: mlp_variants.mlp3d_staged(
        *a, cb=cb), "mlp3d_staged") for cb in (1, 2, 4)},
    **{f"mlp_pipe s={s} tm={tm}": (lambda a, s=s, tm=tm: mlp_variants.mlp_pipe(
        *a, splits=s, tm=tm), "mlp_pipe") for s, tm in ((2, 128), (1, 128),
                                                        (1, 64))},
}


@pytest.mark.parametrize("B,N,D", [(4, 197, 384), (4, 50, 384),
                                   (3, 197, 512), (2, 100, 128)])
@pytest.mark.parametrize("name", sorted(MLP_VARIANTS))
def test_mlp_variants_equal_k2_and_hold_its_plain_version(dev, name, B, N,
                                                          D):
    """T6, T7 and T3 against the K2 kernel on the same bf16 inputs (equal
    bit for bit: the same rounding points and order of every fp32 sum) and
    against the plain fp32 version (rel < 2e-2); one call launches its
    kernel once and nothing else. B=3 leaves a ragged last tile."""
    call, counter = MLP_VARIANTS[name]
    if counter == "mlp_pipe" and "tm=128" in name and D > 384:
        pytest.skip("tm=128 at D=512 passes the registers")
    cb = int(name.split("cb=")[1]) if "cb=" in name else 1
    if B % cb:
        pytest.skip("cb must divide B")
    t = _block(dev, B, N, D)
    a = [t[k] for k in MLP]
    ops.reset_launch_counts()
    with torch.no_grad():
        got = call(a)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop(counter) == 1 and not any(counts.values())
    with torch.no_grad():
        k2 = fused_mlp.fused_mlp_block(*a)
    assert torch.equal(got, k2)
    assert _rel(got, fused_mlp.fused_mlp_block_plain(*_f32(t, MLP))) < REL


# T6 and T7 against their first designs: the smoke's MLP shapes
# (chip_smoke.VARIANT_SHAPES) and two narrower widths
T6_T7 = {"mlp3d flat": (lambda a, cb: mlp_variants.mlp3d(*a, cb=cb, flat=True),
                        lambda a, cb: mlp_variants.mlp3d_wmma(*a, cb=cb,
                                                              flat=True)),
         "mlp3d loop": (lambda a, cb: mlp_variants.mlp3d(*a, cb=cb,
                                                         flat=False),
                        lambda a, cb: mlp_variants.mlp3d_wmma(*a, cb=cb,
                                                              flat=False)),
         "mlp3d_staged": (lambda a, cb: mlp_variants.mlp3d_staged(*a, cb=cb),
                          lambda a, cb: mlp_variants.mlp3d_staged_wmma(
                              *a, cb=cb))}


@pytest.mark.parametrize("B,N,D", [(8, 197, 384), (8, 50, 384),
                                   (3, 197, 384), (6, 197, 384),
                                   (4, 197, 512), (2, 100, 256),
                                   (2, 100, 128)])
@pytest.mark.parametrize("name", sorted(T6_T7))
def test_t6_t7_equal_their_former_designs_and_k2(dev, name, B, N, D):
    """T6 (flat and per image) and T7 on K2's tail against their first
    designs (``mlp3d_wmma``, ``mlp3d_staged_wmma``) and the K2 kernel on the
    same bf16 inputs, bit for bit, at every cb of the tool's sweep that
    divides B (else cb=1); one call launches the variant once and nothing
    else, and the former designs count no launch."""
    new, former = T6_T7[name]
    counter = name.split()[0]
    t = _block(dev, B, N, D)
    a = [t[k] for k in MLP]
    with torch.no_grad():
        k2 = fused_mlp.fused_mlp_block(*a)
        for cb in [cb for cb in (2, 4, 8) if B % cb == 0] or [1]:
            ops.reset_launch_counts()
            got, was = new(a, cb), former(a, cb)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts.pop(counter) == 1 and not any(counts.values())
            assert torch.equal(got, k2), cb
            assert torch.equal(got, was), cb


@pytest.mark.parametrize("B,N,D,H", [(4, 197, 384, 12), (4, 197, 384, 6),
                                     (4, 50, 384, 12), (2, 197, 384, 3),
                                     (3, 100, 256, 2)])
@pytest.mark.parametrize("cb", [1, 2])
def test_attn_staged_equals_k1_and_holds_its_plain_version(dev, cb, B, N, D,
                                                           H):
    """T4 against the K1 kernel (equal bit for bit) and its plain fp32
    version (rel < 2e-2); one call launches T4 once and K1 never."""
    if B % cb:
        pytest.skip("cb must divide B")
    t = _block(dev, B, N, D)
    a = [t[k] for k in ATTN]
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    with torch.no_grad():
        got = attn_variants.attn_staged(*a, H, scale, cb=cb)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop("attn_staged") == 1 and not any(counts.values())
    with torch.no_grad():
        k1 = fused_attn.fused_attention_block(*a, H, scale)
    assert torch.equal(got, k1)
    ref = fused_attn.fused_attention_block_plain(*_f32(t, ATTN), H, scale)
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("B,N,D,H", [(8, 197, 384, 12), (8, 50, 384, 12),
                                     (3, 197, 384, 12), (4, 197, 512, 8),
                                     (8, 197, 384, 6), (8, 208, 384, 3),
                                     (4, 100, 256, 2), (2, 100, 128, 4)])
def test_t3_t4_equal_their_former_designs_and_k1_k2(dev, B, N, D, H):
    """T3 (K2's tail over 128-row tiles of two 64-row sub-tiles, in
    ping-pong and in lockstep, and K2's own tile) and T4 (K1's chain with a
    staged sibling of K1's asynchronous core) against their former designs
    (``mlp_pipe_mma`` at its own default, ``attn_staged_wmma``) and the K2 /
    K1 kernels on the same bf16 inputs, bit for bit, at every argument of
    their tools' sweeps that the shape takes (T4: every cb of 2, 4 that
    divides B, else cb=1); one call launches the variant once and nothing
    else, and the former designs count no launch."""
    t = _block(dev, B, N, D)
    m, a = [t[k] for k in MLP], [t[k] for k in ATTN]
    scale = (D // H) ** -0.5
    with torch.no_grad():
        k2 = fused_mlp.fused_mlp_block(*m)
        k1 = fused_attn.fused_attention_block(*a, H, scale)
        was = mlp_variants.mlp_pipe_mma(*m, **({} if D <= 384 else
                                               dict(splits=2, tm=32)))
        assert torch.equal(was, k2)
        for s, tm in ((2, 128), (1, 128), (1, 64)):
            if tm == 128 and D > 384:
                continue
            ops.reset_launch_counts()
            got = mlp_variants.mlp_pipe(*m, splits=s, tm=tm)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts.pop("mlp_pipe") == 1 and not any(counts.values())
            assert torch.equal(got, k2), (s, tm)
        for cb in [cb for cb in (2, 4) if B % cb == 0] or [1]:
            ops.reset_launch_counts()
            got = attn_variants.attn_staged(*a, H, scale, cb=cb)
            was = attn_variants.attn_staged_wmma(*a, H, scale, cb=cb)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts.pop("attn_staged") == 1 and not any(counts.values())
            assert torch.equal(got, k1), cb
            assert torch.equal(got, was), cb


def test_the_variants_refuse_on_the_card_too(dev):
    t = _block(dev, 3, 197, 384)
    m, a = [t[k] for k in MLP], [t[k] for k in ATTN]
    with torch.no_grad():
        with pytest.raises(ValueError, match="must divide B"):
            mlp_variants.mlp3d(*m, cb=2)
        with pytest.raises(ValueError, match="must divide B"):
            attn_variants.attn_staged(*a, 12, 32 ** -0.5, cb=2)
        with pytest.raises(ValueError, match="registers"):
            mlp_variants.mlp_pipe(*m, splits=4, tm=32)
        with pytest.raises(ValueError, match="bfloat16"):
            mlp_variants.mlp3d_staged(m[0].float(), *m[1:], cb=1)
    with pytest.raises(RuntimeError, match="forward only"):
        mlp_variants.mlp3d(m[0], m[1].clone().requires_grad_(), *m[2:],
                           cb=1)


ATTN_VARIANTS = {"attn_pairs": attn_variants.attn_pairs,
                 "attn_rolling": attn_variants.attn_rolling}


@pytest.mark.parametrize("B,N,D,H", [(4, 197, 384, 12), (4, 197, 384, 6),
                                     (4, 50, 384, 12), (4, 208, 384, 3),
                                     (6, 100, 256, 2)])
@pytest.mark.parametrize("cb", [2, 4])
@pytest.mark.parametrize("name", sorted(ATTN_VARIANTS))
def test_attn_pairs_and_rolling_equal_k1_and_hold_its_plain_version(
        dev, name, cb, B, N, D, H):
    """T1 and T2 against the K1 kernel (equal bit for bit) and its plain
    fp32 version (rel < 2e-2); one call launches the variant once and K1
    never. N=208 is the head_dim-128 limit; B=6 at cb=4 is refused."""
    t = _block(dev, B, N, D)
    a = [t[k] for k in ATTN]
    scale = (D // H) ** -0.5
    if B % cb:
        with pytest.raises(ValueError, match="must divide B"):
            ATTN_VARIANTS[name](*a, H, scale, cb=cb)
        return
    ops.reset_launch_counts()
    with torch.no_grad():
        got = ATTN_VARIANTS[name](*a, H, scale, cb=cb)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop(name) == 1 and not any(counts.values())
    with torch.no_grad():
        k1 = fused_attn.fused_attention_block(*a, H, scale)
    assert torch.equal(got, k1)
    ref = fused_attn.fused_attention_block_plain(*_f32(t, ATTN), H, scale)
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("B,N,D,H", [(4, 197, 384, 12), (4, 197, 384, 6),
                                     (4, 50, 384, 12), (4, 208, 384, 3),
                                     (3, 100, 256, 2)])
@pytest.mark.parametrize("cb", [1, 2, 4])
def test_staged_bwd_equals_k5_and_holds_its_plain_version(dev, cb, B, N, D,
                                                          H):
    """T5 against the K5 kernels on all seven outputs (equal bit for bit:
    the same stages per warp and K5's reductions) and against the plain
    fp32 backward (rel < 2e-2 each); one call launches T5 once and K5
    never. cb=1 and B=3 at cb=1 leave a warpgroup without an image."""
    if B % cb:
        pytest.skip("cb must divide B")
    t = _block(dev, B, N, D)
    g = _rnd(torch.Generator().manual_seed(3), B, N, D).bfloat16().to(dev)
    a = [g] + [t[k] for k in ATTN[:-1]]
    scale = (D // H) ** -0.5
    ops.reset_launch_counts()
    got = attn_variants.staged_bwd(*a, H, scale, cb=cb)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop("staged_bwd") == 1 and not any(counts.values())
    k5 = fused_attn.fused_attention_block_bwd(*a, H, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, k5))
    ref = fused_attn.fused_attention_block_bwd_plain(
        *[v.float() for v in a], H, scale)
    assert all(_rel(x, y) < REL for x, y in zip(got, ref))


@pytest.mark.parametrize("B,N,D,H", [(8, 197, 384, 12), (8, 50, 384, 12),
                                     (3, 197, 384, 12), (4, 197, 512, 8),
                                     (8, 197, 384, 6), (8, 208, 384, 3),
                                     (4, 100, 256, 2)])
def test_t2_t5_equal_their_former_designs_and_k1_k5(dev, B, N, D, H):
    """T2 (K1's chain with a rolling sibling of K1's asynchronous core) and
    T5 (K5's chain with K5's asynchronous core, staged) against their
    former designs (``attn_rolling_wmma``, ``staged_bwd_former``) and the
    K1 / K5 kernels on the same bf16 inputs, bit for bit (T5 on all seven
    outputs), at every cb of their tools' sweeps that divides B (else
    cb=1); one call launches the variant once and nothing else, and the
    former designs count no launch."""
    t = _block(dev, B, N, D)
    a = [t[k] for k in ATTN]
    g = _rnd(torch.Generator().manual_seed(3), B, N, D).bfloat16().to(dev)
    scale = (D // H) ** -0.5
    with torch.no_grad():
        k1 = fused_attn.fused_attention_block(*a, H, scale)
        k5 = fused_attn.fused_attention_block_bwd(g, *a[:6], H, scale)
        for name, cbs in (("attn_rolling", (4, 8, 16)),
                          ("staged_bwd", (2, 4))):
            for cb in [cb for cb in cbs if B % cb == 0] or [1]:
                ops.reset_launch_counts()
                if name == "attn_rolling":
                    got = (attn_variants.attn_rolling(*a, H, scale, cb=cb),)
                    was = (attn_variants.attn_rolling_wmma(*a, H, scale,
                                                           cb=cb),)
                    base = (k1,)
                else:
                    got = attn_variants.staged_bwd(g, *a[:6], H, scale,
                                                   cb=cb)
                    was = attn_variants.staged_bwd_former(g, *a[:6], H,
                                                          scale, cb=cb)
                    base = k5
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                assert counts.pop(name) == 1 and not any(counts.values())
                assert all(torch.equal(x, y) for x, y in zip(got, base)), cb
                assert all(torch.equal(x, y) for x, y in zip(got, was)), cb


@pytest.mark.parametrize("B,N,D,H", [(8, 197, 384, 12), (8, 197, 384, 6),
                                     (8, 197, 384, 3), (8, 50, 384, 12),
                                     (8, 208, 384, 3), (8, 256, 384, 12),
                                     (8, 256, 384, 6), (8, 128, 256, 2),
                                     (8, 100, 512, 4)])
@pytest.mark.parametrize("cb", [2, 4, 8])
def test_t1_equals_k1_and_its_former_design(dev, cb, B, N, D, H):
    """T1 (K1's chain with the pair core) against the K1 kernel and its
    former design (``attn_pairs_wmma``) on the same bf16 inputs, bit for
    bit, at head_dim 32, 64 and 128 and every ring ``pairs_plan`` picks
    (two slots of q, K and V; two of K and V at 256 keys; one of q, K and V
    at head_dim 64 past 128 keys and 128 at 128; one of K and V at head_dim
    128, 208 keys); one call launches T1 once and nothing else, and the
    former design counts no launch."""
    t = _block(dev, B, N, D)
    a = [t[k] for k in ATTN]
    scale = (D // H) ** -0.5
    with torch.no_grad():
        k1 = fused_attn.fused_attention_block(*a, H, scale)
        ops.reset_launch_counts()
        got = attn_variants.attn_pairs(*a, H, scale, cb=cb)
        was = attn_variants.attn_pairs_wmma(*a, H, scale, cb=cb)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop("attn_pairs") == 1 and not any(counts.values())
    assert torch.equal(got, k1)
    assert torch.equal(got, was)


def test_the_attention_variants_refuse_on_the_card_too(dev):
    t = _block(dev, 4, 209, 384)
    a = [t[k] for k in ATTN]
    with torch.no_grad():
        for op in (attn_variants.attn_pairs, attn_variants.attn_pairs_wmma):
            with pytest.raises(ValueError, match="must be even"):
                op(*a, 12, 32 ** -0.5, cb=1)
            with pytest.raises(ValueError, match="N <= 208"):
                op(*a, 3, 128 ** -0.5, cb=2)
        for op in ATTN_VARIANTS.values():
            with pytest.raises(ValueError, match="N <= 208"):
                op(*a, 3, 128 ** -0.5, cb=2)
        with pytest.raises(ValueError, match="N <= 208"):
            attn_variants.staged_bwd(a[0], *a[:6], 3, 128 ** -0.5)
        with pytest.raises(ValueError, match="bfloat16"):
            attn_variants.attn_rolling(a[0].float(), *a[1:], 12, 32 ** -0.5,
                                       cb=2)
    with pytest.raises(RuntimeError, match="forward only"):
        attn_variants.attn_pairs(a[0], a[1].clone().requires_grad_(), *a[2:],
                                 12, 32 ** -0.5, cb=2)


@pytest.mark.parametrize("B,N,D,H", [(8, 197, 384, 12), (2, 197, 768, 12),
                                     (4, 50, 384, 6), (4, 50, 384, 3),
                                     (3, 208, 384, 3), (2, 256, 384, 3),
                                     (3, 100, 256, 2)])
def test_k5_k7_equal_their_former_chains_and_hold_their_plain_versions(
        dev, B, N, D, H):
    """K5 and K7 on the wgmma core and K5's asynchronous attention core
    against the chains they ran before (``*_bwd_wmma``) on the same bf16
    inputs: all seven outputs equal bit for bit (every stage keeps its
    former one's rounding points, sum order and K slices), and within rel
    2e-2 of the plain fp32 backward; one launch each, the former chains
    none. Head_dim 128 at N=208 and N=256 runs the core's two- and
    one-slot rings."""
    t = _block(dev, B, N, D)
    g = _rnd(torch.Generator().manual_seed(4), B, N, D).bfloat16().to(dev)
    scale = (D // H) ** -0.5
    a = [g] + [t[k] for k in ATTN[:-1]]
    m = [g] + [t[k] for k in MLP[:-1]]
    ops.reset_launch_counts()
    got = (fused_attn.fused_attention_block_bwd(*a, H, scale),
           fused_mlp.fused_mlp_block_bwd(*m))
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "fused_attention_block_bwd": 1, "fused_mlp_block_bwd": 1}
    former = (fused_attn.fused_attention_block_bwd_wmma(*a, H, scale),
              fused_mlp.fused_mlp_block_bwd_wmma(*m))
    plain = (fused_attn.fused_attention_block_bwd_plain(
        *[v.float() for v in a], H, scale),
        fused_mlp.fused_mlp_block_bwd_plain(*[v.float() for v in m]))
    for new, old, ref in zip(got, former, plain):
        assert all(torch.equal(x, y) for x, y in zip(new, old))
        assert all(_rel(x, y) < REL for x, y in zip(new, ref))


# the backward GEMMs: label -> (form, a's shape, b's shape, tiles for the
# K split); at B=256 (50,432 rows) every block walks two tiles or more, each
# of more K stages than the ring holds
BWD_GEMMS = {
    "dWqkv B=8": ("tn", (1576, 1152), (1576, 384), 27),
    "dW1 B=8": ("tn", (1576, 1536), (1576, 384), 36),
    "dW2 B=3 N=50": ("tn", (150, 384), (150, 1536), 36),
    "dWqkv B=256": ("tn", (50432, 1152), (50432, 384), 27),
    "dO B=8": ("nn", (1576, 384), (384, 384), 0),
    "dh B=8": ("nn_f32", (1576, 1152), (1152, 384), 0),
    "dh1 B=256": ("nn_f32", (50432, 1536), (1536, 384), 0),
}


@pytest.mark.parametrize("label", sorted(BWD_GEMMS))
def test_gemm_mn_equals_gemm_bwd_and_holds_its_plain_version(dev, label):
    """The MN-major forms of the wgmma core (K5's and K7's products)
    against gemm_bwd.cuh's WMMA GEMMs on the same bf16 inputs: equal bit
    for bit (column sums included), within rel 2e-2 of the plain fp32
    version; one launch each."""
    form, sa, sb, tiles = BWD_GEMMS[label]
    g = torch.Generator().manual_seed(6)
    a = _rnd(g, *sa).bfloat16().to(dev)
    b = _rnd(g, *sb, std=sb[0] ** -0.5).bfloat16().to(dev)
    S, kc = (fused_attn.launch.k_split(sa[0], tiles, 32) if form == "tn"
             else (1, 0))
    ops.reset_launch_counts()
    got = gemm.gemm_mn(a, b, form, S, kc)
    ref = gemm.gemm_bwd(a, b, form, S, kc)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "gemm_mn": 1, "gemm_bwd": 1}
    plain = gemm.gemm_bwd_plain(a, b, form)
    if form != "tn":
        got, ref, plain = (got,), (ref,), (plain,)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert all(_rel(x, y) < REL for x, y in zip(got, plain))


def test_moco_step_kernel_path_holds_the_plain_path(dev):
    """One MoCo v2-queue step (vit_small, 224 px, B=8, MoCo's default heads
    and K=65536 queue, LARS): the kernel path against the plain path in
    bf16 from the same state and batch, the loss within rel 1e-2 (the
    train-step bar of PERF.md section 2); launches K1 24, K2 22, K3 2
    (both towers), K5 12, K7 12 (the query tower's backward), none on the
    plain path. Then each query-tower block's gradient within rel 5e-2,
    both encoders run under the plain step's cotangent on their CLS
    features (at random init the MoCo heads' BatchNorm-ReLU layers turn
    the bf16 rounding differences of the features into far larger
    gradient differences, whatever the kernels)."""
    _moco_step_parity(dev, in_chans=3)


def test_moco_step_4ch_kernel_path_holds_the_plain_path(dev):
    """The same step on the stacked CXR-gray + Enh input (``--in-chans
    4``): a (384, 4, 16, 16) patch weight, the same launches and bars."""
    _moco_step_parity(dev, in_chans=4)


def _moco_step_parity(dev, in_chans: int):
    import copy

    from mfvit_tpu_torch.ssl import moco
    from mfvit_tpu_torch.train import optim

    gen = torch.Generator().manual_seed(0)
    model0 = moco.MoCo(moco.MoCoConfig(), vit.get_config("vit_small"),
                       in_chans=in_chans, generator=gen)
    assert model0.base.encoder.patch_embed.proj.weight.shape == (
        384, in_chans, 16, 16)
    q, k = (torch.randn(8, 224, 224, in_chans, generator=gen).to(dev)
            .bfloat16() for _ in range(2))
    runs = {}
    for ref in (False, True):
        model = copy.deepcopy(model0).to(dev)
        opt = optim.build_optimizer("lars", model.trainable(), 0.1,
                                    weight_decay=1e-6)
        step = moco.make_pretrain_step(model.cfg, reference=ref)
        feats = []
        model.base.encoder.register_forward_hook(
            lambda mod, args, out: feats.append(out) or out.retain_grad())
        ops.reset_launch_counts()
        loss = step(model, opt, q, k, 0.99).item()
        torch.cuda.synchronize()
        counts = {n: v for n, v in ops.launch_counts().items() if v}
        runs[ref] = (loss, counts, int(model.queue_ptr), feats[0].grad)
    (lk, ck, pk, _), (lp, cp, pp, cot) = runs[False], runs[True]
    assert ck == {"fused_attention_block": 24, "fused_mlp_block": 22,
                  "fused_mlp_block_final_ln": 2,
                  "fused_attention_block_bwd": 12, "fused_mlp_block_bwd": 12}
    assert cp == {} and pk == pp == 8
    assert abs(lk - lp) / abs(lp) < 1e-2
    grads = {}
    for ref in (False, True):
        model = copy.deepcopy(model0).to(dev)
        feats = model.base.encoder(q, reference=ref, stop_grad_conv1=True)
        feats.backward(cot)
        grads[ref] = [torch.cat([p.grad.flatten() for p in blk.parameters()])
                      for blk in model.base.encoder.blocks]
    assert max(_rel(a, b) for a, b in zip(grads[False], grads[True])) < 5e-2


def test_gpt_fusion_step_kernel_path_holds_the_plain_path(dev):
    """One ``--semi-supervised`` step with the GPT fusion head (vit_small,
    224 px, B=4, the default 8-block head of ``fuse --fusion-arch gpt``,
    Adam): the kernel path against the plain path in bf16 from the same
    weights and batch, the loss within rel 1e-2 (PERF.md section 2's
    train-step bar); launches K1 24, K2 22, K3 2, K5 24, K7 24 and no K4
    (the head is plain PyTorch), none on the plain path."""
    import argparse
    import copy

    from torch import nn

    from mfvit_tpu_torch.cli.common import fusion_head
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(0)
    cfg = vit.get_config("vit_small")
    args = argparse.Namespace(fusion_arch="gpt", gpt_layers=8, num_classes=3)
    models0 = nn.ModuleDict({"cxr": vit.ViT(cfg, 3, generator=gen),
                             "enh": vit.ViT(cfg, 3, generator=gen),
                             "fus": fusion_head(args, cfg, gen)})
    xc, xe = (torch.randn(4, 224, 224, 3, generator=gen).to(dev).bfloat16()
              for _ in range(2))
    labels = torch.tensor([0, 1, 2, 0], device=dev)
    runs = {}
    for ref in (False, True):
        models = copy.deepcopy(models0).to(dev)
        opt = optim.build_optimizer("adam", models.named_parameters(), 1e-4)
        step, _ = steps.make_fusion_steps(reference=ref, fusion_arch="gpt")
        ops.reset_launch_counts()
        loss = step(models, opt, xc, xe, labels)[0].item()
        torch.cuda.synchronize()
        runs[ref] = (loss, {n: v for n, v in ops.launch_counts().items()
                            if v})
    (lk, ck), (lp, cp) = runs[False], runs[True]
    assert ck == {"fused_attention_block": 24, "fused_mlp_block": 22,
                  "fused_mlp_block_final_ln": 2,
                  "fused_attention_block_bwd": 24, "fused_mlp_block_bwd": 24}
    assert cp == {}
    assert abs(lk - lp) / abs(lp) < 1e-2


def test_crossvit_cnn_kernel_path_holds_the_plain_path(dev):
    """``models.crossvit_cnn.fused_forward`` (vit_small, resnet18, the
    head at its defaults) at B=4, 224 px, bf16: the kernel path's logits
    within REL of the plain path's; the ViT launches K1 12, K2 11, K3 1."""
    from mfvit_tpu_torch.models import crossvit_cnn
    from mfvit_tpu_torch.nn import resnet

    gen = torch.Generator().manual_seed(1)
    model = vit.ViT(vit.get_config("vit_small"), 3, generator=gen)
    cnn = resnet.ResNet(resnet.get_config("resnet18"), generator=gen)
    fus = crossvit_cnn.CrossViTCNN(generator=gen)
    model, cnn, fus = (m.to(dev).eval() for m in (model, cnn, fus))
    img = torch.randn(4, 224, 224, 3, generator=gen).to(dev).bfloat16()
    out = {}
    with torch.inference_mode():
        for ref in (True, False):
            ops.reset_launch_counts()
            out[ref] = crossvit_cnn.fused_forward(model, cnn, fus, img,
                                                  reference=ref)
    torch.cuda.synchronize()
    assert {n: v for n, v in ops.launch_counts().items() if v} == {
        "fused_attention_block": 12, "fused_mlp_block": 11,
        "fused_mlp_block_final_ln": 1}
    assert out[False].shape == (4, 3)
    assert _rel(out[False], out[True]) < REL


def test_bmm_f32_holds_the_upcast_product(dev):
    """``nn.layers.bmm_f32`` on bf16 CUDA operands, the GPT head's score
    product at its shape (4 heads of 96 over 394 tokens, B=2): the
    fp32-output GEMM on the tensor cores against the fp32 product of the
    upcast operands, within rel 1e-5 (bf16 products are exact in fp32, so
    only the summation order differs); its gradients, taken in bf16 as
    ``linear_f32``'s are, within REL of the upcast product's."""
    from mfvit_tpu_torch.nn.layers import bmm_f32

    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(8, 394, 96, generator=g).to(dev).bfloat16()
            .requires_grad_() for _ in range(2))
    got = bmm_f32(q, k.mT)
    want = q.float() @ k.float().mT
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    cot = torch.randn(8, 394, 394, generator=g).to(dev)
    dq, dk = torch.autograd.grad(got, (q, k), cot)
    wq, wk = torch.autograd.grad(want, (q, k), cot)
    assert _rel(dq, wq) < REL and _rel(dk, wk) < REL
