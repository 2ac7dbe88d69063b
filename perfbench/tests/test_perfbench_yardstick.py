"""The benchmark's FLOP and byte counts against hand counts at two small
shapes."""
import pytest

from perfbench import yardstick as y

CFG = {"hidden_size": 64, "num_attention_heads": 2, "num_hidden_layers": 3,
       "intermediate_size": 256, "patch_size": 16, "num_channels": 3,
       "num_classes": 3}


@pytest.mark.parametrize("img", [32, 48])
def test_vit_and_model_flops_by_hand(img):
    n = (img // 16) ** 2
    N = n + 1
    # by hand: qkv 3 D^2, proj D^2, fc1 and fc2 D H each per token;
    # q k^T and p v N D per token; 2 flops a multiply-add
    block = 2 * N * (64 * 192 + 64 * 64 + 2 * 64 * 256) + 2 * 2 * N * N * 64
    v = y.vit_forward_flops(CFG, img)
    assert v == {"patch": 2 * n * 768 * 64, "blocks": 3 * block,
                 "head": 2 * 64 * 3}
    head = 2 * (2 * (2 * N * 64 * 64) + 2 * 64 * 64 + 2 * 2 * N * 64
                + 2 * 64 * 64) + 2 * 2 * 64 * 3
    assert y.fusion_head_flops(CFG, img) == head
    pair = 2 * sum(v.values()) + head
    assert y.serve_flops_per_pair(CFG, img) == pair
    assert y.train_flops_per_sample(CFG, img) == 3 * pair - 2 * v["patch"]


@pytest.mark.parametrize("B,N,D,H,heads", [(2, 5, 64, 256, 2),
                                           (3, 17, 128, 512, 4)])
def test_kernel_bounds_by_hand(B, N, D, H, heads):
    M = B * N
    bf, f32, hbm = 989e12, 67e12, 3.35e12
    # K1: 2 M D 4D + two N x N x D products; bf16 x in and out, weights
    ops = 8 * M * D * D + 4 * B * N * N * D
    byts = 4 * M * D + 8 * D * D + 24 * D
    assert y.attn_fwd_bound(B, N, D, heads)[0] == pytest.approx(
        max(ops / bf, B * heads * N * N / y.PEAK["sfu"], byts / hbm))
    # K2: fc1 and fc2
    assert y.mlp_fwd_bound(B, N, D, H)[0] == pytest.approx(max(
        4 * M * D * H / bf, (4 * M * D + 4 * D * H + 4 * (H + 5 * D)) / hbm))
    # K5: 9 M D^2 + M D^2 bf16 products times 2, six attention products,
    # dWproj in fp32
    ops5 = 2 * (9 * M * D * D + M * D * D) + 6 * 2 * B * N * N * D
    byts5 = 6 * M * D + 8 * D * D + 16 * D * D + 48 * D
    assert y.attn_bwd_bound(B, N, D, heads)[0] == pytest.approx(
        max(ops5 / bf, 2 * M * D * D / f32, byts5 / hbm))
    # K7: five M D H products
    assert y.mlp_bwd_bound(B, N, D, H)[0] == pytest.approx(max(
        10 * M * D * H / bf,
        (6 * M * D + 4 * D * H + 8 * D * H + 4 * (H + 5 * D)) / hbm))
    # K4: both token streams read once bound it at these shapes
    t, by = y.fusion_head_bound(B, N, D, heads)
    assert by == "bytes"
    assert t == pytest.approx((4 * B * N * D + 16 * D * D + 8 * B * D
                               + 48 * D) / hbm)


def test_bound_names_what_bounds_it():
    assert y.bound({"bf16": 989e12}, 1.0) == (1.0, "operations")
    assert y.bound({"bf16": 1.0}, 3.35e12) == (1.0, "bytes")
