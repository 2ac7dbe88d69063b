"""The port's backward kernels' plain versions (K5, K7 and K3's backward),
the K4 Function's gradient, the optimizers and the metrics against the JAX
package on the CPU, on the same numpy inputs.

Tolerances:
- fp32 backwards against the JAX XLA references and ``jax.grad``: rtol
  1e-4, atol 1e-5 (fp32 math; the sums run in another order);
- bf16 backwards against the Pallas backward kernels in interpret mode:
  max|diff| / max|ref| < 1e-2 per output. Both round at the same points,
  but a sum taken in another order can flip a bf16 rounding (one bf16 ulp
  is 2^-8 = 3.9e-3 relative), and the flip carries into what follows;
- optimizer trajectories: rtol 1e-5, atol 1e-6 (fp32 updates, the
  schedule in double on the port's side and in fp32 in optax);
- metrics: exact, or rtol 1e-12 where both sides compute in float64."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import layers as jlayers
from mfvit_tpu.ops import fused_attn as jfa
from mfvit_tpu.ops import fused_fusion as jff
from mfvit_tpu.ops import fused_mlp as jfm
from mfvit_tpu.train import metrics as jmetrics
from mfvit_tpu.train import optim as joptim
from mfvit_tpu_torch.exp.checkpoint import fusion_state_from_jax
from mfvit_tpu_torch.models.fusion import Fusion
from mfvit_tpu_torch.ops import fused_attn, fused_fusion, fused_mlp
from mfvit_tpu_torch.train import metrics, optim

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 1e-2
B, N, H, DH = 2, 67, 4, 16
D = H * DH
SCALE = DH ** -0.5


def _np(t):
    return np.asarray(t, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _case(seed, b, n, d, hd):
    """One block's inputs, weights (JAX (in, out) layout) and cotangent."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, n, d), g=f(b, n, d), ln_s=1 + f(d, std=0.1),
        ln_b=f(d, std=0.1), wqkv=f(d, 3 * d, std=d ** -0.5),
        bqkv=f(3 * d, std=0.1), wproj=f(d, d, std=d ** -0.5),
        bproj=f(d, std=0.1), w1=f(d, hd, std=d ** -0.5), b1=f(hd, std=0.1),
        w2=f(hd, d, std=hd ** -0.5), b2=f(d, std=0.1),
        fs=1 + f(d, std=0.1), fb=f(d, std=0.1))


@pytest.fixture(scope="module")
def blk():
    return _case(0, B, N, D, 4 * D)


ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")


def _port(p, keys, dtype=torch.float32):
    """Port arguments: activations in ``dtype``, matrices transposed to the
    torch (out, in) layout, vectors fp32."""
    out = []
    for k in keys:
        v = _t(p[k].T if p[k].ndim == 2 else p[k])
        out.append(v.to(dtype) if k in ("x", "g") else v)
    return out


def _jax(p, keys, dtype=jnp.float32):
    return [jnp.asarray(p[k], dtype) if k in ("x", "g") else jnp.asarray(p[k])
            for k in keys]


def _to_jax_order(port_grads):
    """(dx, dln_s, dln_b, dw_a, db_a, dw_b, db_b) in the torch layout ->
    the JAX (dx, dscale, dbias, dw_a^T, db_a, dw_b^T, db_b)."""
    return [_np(g.float().T if g.dim() == 2 else g.float())
            for g in port_grads]


def test_attention_bwd_plain_matches_xla_reference(blk):
    want = jfa._bwd_xla_reference(H, SCALE, False, tuple(_jax(blk, ATTN)),
                                  jnp.asarray(blk["g"]))
    got = fused_attn.fused_attention_block_bwd_plain(
        _t(blk["g"]), *_port(blk, ATTN[:-1]), H, SCALE)
    for gv, w in zip(_to_jax_order(got), want):
        np.testing.assert_allclose(gv, _np(w), **TOL)


def test_mlp_bwd_plain_matches_xla_reference(blk):
    want = jfm._bwd_xla_reference(False, tuple(_jax(blk, MLP)),
                                  jnp.asarray(blk["g"]))
    got = fused_mlp.fused_mlp_block_bwd_plain(
        _t(blk["g"]), *_port(blk, MLP[:-1]))
    for gv, w in zip(_to_jax_order(got), want):
        np.testing.assert_allclose(gv, _np(w), **TOL)


def test_final_ln_bwd_matches_jax_grad(blk):
    """K3's backward (epilogue LayerNorm on an fp32 recompute, then K7's
    plain version) against jax.grad of the XLA final-LN block."""
    def xla(x, ln_s, ln_b, w1, b1, w2, b2, fs, fb):
        ln = {"scale": ln_s, "bias": ln_b}
        mp = {"fc1": {"w": w1, "b": b1}, "fc2": {"w": w2, "b": b2}}
        o = x + jlayers.mlp(mp, jlayers.layernorm(ln, x))
        return jlayers.layernorm({"scale": fs, "bias": fb}, o)

    args = _jax(blk, MLP + ("fs", "fb"))
    _, vjp = jax.vjp(xla, *args)
    want = vjp(jnp.asarray(blk["g"]))
    leaves = [v.requires_grad_() for v in _port(blk, MLP + ("fs", "fb"))]
    out = fused_mlp.fused_mlp_block_final_ln(*leaves)
    got = torch.autograd.grad(out, leaves, _t(blk["g"]))
    for gv, w in zip(got, want):
        np.testing.assert_allclose(_np(gv.T if gv.dim() == 2 else gv),
                                   _np(w), **TOL)


def test_attention_bwd_bf16_matches_pallas_interpret(blk):
    bf = jnp.bfloat16
    dx, dwqkv, dbqkv, dwproj, dbproj, ds, db = jfa._fused_attn_bwd_impl(
        jnp.asarray(blk["g"], bf), *_jax(blk, ATTN[:-1], bf), H, SCALE,
        interpret=True)
    want = (dx, ds, db, dwqkv, dbqkv, dwproj, dbproj)
    got = fused_attn.fused_attention_block_bwd_plain(
        _t(blk["g"]).bfloat16(), *_port(blk, ATTN[:-1], torch.bfloat16), H,
        SCALE)
    assert got[0].dtype == torch.bfloat16
    for name, gv, w in zip(("dx", "dln_s", "dln_b", "dwqkv", "dbqkv",
                            "dwproj", "dbproj"), _to_jax_order(got), want):
        assert _rel(gv, w) < BF16_REL, name


def test_mlp_bwd_bf16_matches_pallas_interpret(blk):
    bf = jnp.bfloat16
    want = jfm._fused_mlp_bwd_impl(jnp.asarray(blk["g"], bf),
                                   *_jax(blk, MLP[:-1], bf), True)
    got = fused_mlp.fused_mlp_block_bwd_plain(
        _t(blk["g"]).bfloat16(), *_port(blk, MLP[:-1], torch.bfloat16))
    for name, gv, w in zip(("dx", "dln_s", "dln_b", "dw1", "db1", "dw2",
                            "db2"), _to_jax_order(got), want):
        assert _rel(gv, w) < BF16_REL, name


def test_bigdim_bwd_matches_pallas_interpret():
    """At D > 512 the JAX package splits the backward (K6, K8); the port's
    one backward per half gives the same gradients (bf16, tiny N). K6
    rounds o to bf16 for dWproj where K5 keeps it in fp32, so the bar is
    the bf16 one."""
    p = _case(1, 1, 5, 768, 3072)
    bf = jnp.bfloat16
    g = jnp.asarray(p["g"], bf)
    dx, dwqkv, dbqkv, dwproj, dbproj, ds, db = jfa._fused_attn_bwd_bigdim(
        g, *_jax(p, ATTN[:-1], bf), 12, 64 ** -0.5, interpret=True)
    got = fused_attn.fused_attention_block_bwd_plain(
        _t(p["g"]).bfloat16(), *_port(p, ATTN[:-1], torch.bfloat16), 12,
        64 ** -0.5)
    for gv, w in zip(_to_jax_order(got),
                     (dx, ds, db, dwqkv, dbqkv, dwproj, dbproj)):
        assert _rel(gv, w) < BF16_REL
    want = jfm._fused_mlp_bwd_bigdim(g, *_jax(p, MLP[:-1], bf), True)
    got = fused_mlp.fused_mlp_block_bwd_plain(
        _t(p["g"]).bfloat16(), *_port(p, MLP[:-1], torch.bfloat16))
    for gv, w in zip(_to_jax_order(got), want):
        assert _rel(gv, w) < BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_give_the_plain_backward_with_fp32_weight_grads(blk,
                                                                  dtype):
    """autograd through the Functions equals the explicit plain backward,
    and every parameter gradient is fp32 even for bf16 activations (the
    fp32 master weights go into the op and are cast inside)."""
    g = _t(blk["g"]).to(dtype)
    for fn, bwd, keys, extra in (
            (fused_attn.fused_attention_block,
             fused_attn.fused_attention_block_bwd_plain, ATTN, (H, SCALE)),
            (fused_mlp.fused_mlp_block, fused_mlp.fused_mlp_block_bwd_plain,
             MLP, ())):
        leaves = [v.requires_grad_() for v in _port(blk, keys, dtype)]
        got = torch.autograd.grad(fn(*leaves, *extra), leaves, g)
        want = bwd(g, *_port(blk, keys[:-1], dtype), *extra)
        assert got[0].dtype == dtype
        assert all(gv.dtype == torch.float32 for gv in got[1:])
        for gv, w in zip(got, want):
            assert torch.equal(gv, w.to(gv.dtype))


def test_fusion_function_grad_matches_jax_grad():
    jp = jax.tree.map(np.asarray, jfusion.init(jax.random.PRNGKey(0),
                                               num_classes=3, dim=64,
                                               heads=2))
    rng = np.random.default_rng(4)
    tok_c, tok_e, g_c, g_e = (rng.standard_normal(s).astype(np.float32)
                              for s in ((3, 9, 64), (3, 9, 64), (3, 64),
                                        (3, 64)))
    flat = jff._flatten_layer(jp["encoders"][0]["layers"][0])
    _, vjp = jax.vjp(lambda a, b, f: jff._cls_xla(a, b, f, 2),
                     jnp.asarray(tok_c), jnp.asarray(tok_e), flat)
    want_c, want_e, want_flat = vjp((jnp.asarray(g_c), jnp.asarray(g_e)))
    fus = Fusion(3, 64, 2)
    fus.load_state_dict(fusion_state_from_jax(jp), strict=True)
    pflat = fused_fusion.flatten_layer(
        fus.multi_scale_transformers[0].cross_attn_layers[0], torch.float32)
    pflat = [v.detach().clone().requires_grad_() for v in pflat]
    tc, te = _t(tok_c).requires_grad_(), _t(tok_e).requires_grad_()
    out = fused_fusion.fused_fusion_cls(tc, te, pflat, 2)
    got = torch.autograd.grad(out, [tc, te, *pflat], (_t(g_c), _t(g_e)))
    np.testing.assert_allclose(_np(got[0]), _np(want_c), **TOL)
    np.testing.assert_allclose(_np(got[1]), _np(want_e), **TOL)
    for gv, w in zip(got[2:], want_flat):
        np.testing.assert_allclose(_np(gv.T if gv.dim() == 2 else gv),
                                   _np(w), **TOL)


# ------------------------------------------------------------ optimizers

def test_schedules_match_jax():
    assert optim.scaled_init_lr(3.0, 16, cos=True, entry="finetune") == \
        joptim.scaled_init_lr(3.0, 16, cos=True, entry="finetune") == 6.0
    assert optim.scaled_init_lr(3.0, 16, cos=False, entry="finetune") == 3.0
    for cos, schedule in ((True, ()), (False, (2, 3)), (False, ())):
        mine = optim.finetune_lr(0.5, 4, cos=cos, schedule=schedule,
                                 steps_per_epoch=3)
        want = joptim.finetune_lr(0.5, 4, cos=cos, schedule=schedule,
                                  steps_per_epoch=3)
        for step in range(14):
            np.testing.assert_allclose(mine(step), float(want(step)),
                                       rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "lars"])
def test_optimizer_trajectories_match_optax(name, masked):
    rng = np.random.default_rng(5)
    init = {"w": rng.standard_normal((4, 3)), "b": rng.standard_normal(3),
            "head": {"w": rng.standard_normal((3, 2)),
                     "b": rng.standard_normal(2)}}
    init = jax.tree.map(lambda a: a.astype(np.float32), init)
    noise = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), init) for _ in range(20)]
    sched = optim.finetune_lr(0.05, 4, cos=True, steps_per_epoch=5)
    jsched = joptim.finetune_lr(0.05, 4, cos=True, steps_per_epoch=5)

    jparams = jax.tree.map(jnp.asarray, init)
    mask = joptim.head_only_mask(jparams) if masked else None
    tx = joptim.build_optimizer(name, jsched, weight_decay=0.01,
                                momentum=0.9, trainable_mask=mask)
    state = tx.init(jparams)
    for nz in noise:
        grads = jax.tree.map(lambda p, n: 0.3 * p + n, jparams, nz)
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    names = {"w": ("w",), "b": ("b",), "head.w": ("head", "w"),
             "head.b": ("head", "b")}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    params = {n: torch.nn.Parameter(_t(leaf(init, p)))
              for n, p in names.items()}
    tmask = optim.head_only_mask(params.items()) if masked else None
    opt = optim.build_optimizer(name, params.items(), sched,
                                weight_decay=0.01, momentum=0.9,
                                trainable_mask=tmask)
    for nz in noise:
        opt.zero_grad()
        for n, p in params.items():
            if p.requires_grad:
                p.grad = 0.3 * p.detach() + _t(leaf(nz, names[n]))
        opt.step()
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _np(leaf(jparams, names[n])),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        if masked and n in ("w", "b"):
            assert torch.equal(p.detach(), _t(leaf(init, names[n])))


# --------------------------------------------------------------- metrics

def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((40, 3))
    logits[5] = logits[6]  # ties
    labels = rng.integers(0, 3, 40)
    assert metrics.macro_ovr_auc(logits, labels) == \
        jmetrics.macro_ovr_auc(logits, labels)
    assert metrics.top1_acc(logits, labels) == \
        jmetrics.top1_acc(logits, labels)
    assert np.isnan(metrics.macro_ovr_auc(np.full((4, 3), np.nan),
                                          np.arange(4) % 3))
    mine, want = metrics.AverageMeter("Loss", ":.4e"), \
        jmetrics.AverageMeter("Loss", ":.4e")
    for v, n in ((1.5, 4), (0.25, 2), (3.0, 1)):
        mine.update(v, n)
        want.update(v, n)
    assert str(mine) == str(want)
    np.testing.assert_allclose(mine.avg, want.avg, rtol=1e-12)


# ------------------------------------------------ backward kernel geometry

@pytest.mark.parametrize("K,tiles,step", [
    (50432, 27, 32), (50432, 36, 16), (50432, 3, 1), (6304, 36, 32),
    (394, 108, 32), (50, 3, 1), (1, 1, 32), (4, 200, 1)])
def test_k_split_covers_every_row_with_no_empty_slice(K, tiles, step):
    """The K5/K7 kernels take (S, kc) from ``launch.k_split`` as they are
    and refuse a split that leaves a slice empty or a row out."""
    from mfvit_tpu_torch.ops import launch
    S, kc = launch.k_split(K, tiles, step)
    assert S >= 1 and kc % step == 0
    assert (S - 1) * kc < K <= S * kc
    assert S <= -(-264 // tiles)  # about two blocks per SM, no more
