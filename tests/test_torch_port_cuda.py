"""Kernel-against-plain tests for K1-K4 on the card. They need CUDA, nvcc
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
from mfvit_tpu_torch.ops import fused_attn, fused_fusion, fused_mlp

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
        "fused_attention_block": 1, "fused_mlp_block": 1,
        "fused_mlp_block_final_ln": 1, "fused_fusion_cls": 0}


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


def test_cuda_tensors_never_take_the_plain_version(dev):
    t = _block(dev, 1, 197, 384)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attn.fused_attention_block(*_f32(t, ATTN), 12, 32 ** -0.5)
    with pytest.raises(ValueError, match="N <= 256"):
        x = torch.zeros(1, 300, 384, dtype=torch.bfloat16, device=dev)
        fused_attn.fused_attention_block(x, *[t[k] for k in ATTN[1:]], 12,
                                         32 ** -0.5)


def test_long_sequences_need_k9(dev):
    m = vit.ViT(vit.get_config("vit_small", 384), 3, device=dev)
    with pytest.raises(NotImplementedError, match="K9"):
        m(torch.zeros(1, 384, 384, 3, device=dev))
