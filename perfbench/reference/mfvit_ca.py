"""The plain reference of MF-ViT CA: two ViT branches, the CLS
cross-attention fusion head and the summed heads, in plain PyTorch.

It decides ``correct`` for every cell of this configuration: the benchmark
draws the weights and inputs (``make_params``, ``make_inputs``), hands the
same tensors to the program and to ``decision``/``train_steps`` here, and
compares. It imports nothing of the program under test, and it works
everything else out itself: the sin-cos position table, the patch
embedding, every block, the head.

The model, as github.com/endiqq/Multi-Feature-ViT defines it (``Fus_CrossViT``
over two MoCo v3 ``vits.py`` branches):

- each branch: the stride-16 patch convolution, a CLS token, MoCo v3's
  fixed 2-D sin-cos table (``build_2d_sincos_position_embedding``: the
  meshgrid over (w, h) with ``indexing="ij"``, bands [sin w, cos w, sin h,
  cos h], a zero row for the CLS), pre-norm blocks (LayerNorm eps 1e-6,
  multi-head attention with a qkv bias, the exact-erf GELU MLP), a final
  LayerNorm and a linear head on the CLS row;
- the fusion head at its defaults (one encoder of one cross-attention
  layer): per direction a PreNorm (LayerNorm eps 1e-5) over [own CLS, the
  other branch's patches], one query (the normed CLS row) against every
  normed row (bias-free q, k, v), the out projection with a bias, the
  residual of the un-normed CLS, a LayerNorm (eps 1e-6); the outer residual
  ``tokens + encoder(tokens)`` pooled at the CLS; one linear head per
  direction;
- the decision logits are the sum of the fusion head's two heads and the
  two branch heads.

Departures from the reference repository: dropout and drop-path are left
out (their rates are 0 in the fusion recipe); only the CLS rows of the
fusion encoder's output are computed, since nothing reads the others; the
weights are drawn as ``param_spec`` says, not loaded from a checkpoint.

Precision: float32 everywhere with TF32 off (``fp32_exact``). Every product
goes through ``mm``, so the control can run the same model in a lower
precision: ``fp8_mm`` rounds both operands of every product (and, under
autograd, of every product of the backward) to float8 e4m3 with one
absmax scale a tensor.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


# ----------------------------------------------------------- the weights

# trained transformers carry a few outlier channels in their LayerNorm
# gains (Bondarenko et al. 2021, arXiv:2109.12948; Dettmers et al. 2022,
# arXiv:2208.07339): every OUTLIER_STRIDE-th channel of each block's two
# LayerNorms has OUTLIER_GAIN times the gain
OUTLIER_STRIDE, OUTLIER_GAIN = 97, 12.0


def param_spec(cfg: dict) -> dict:
    """{"cxr": [...], "enh": [...], "fus": [...]}: each a list of (name,
    shape, std, mean) in the state-dict names of MoCo v3's ViT and of
    ``Fus_CrossViT``. Every weight is drawn N(mean, std): matrices that
    feed a softmax or a head at std D**-0.5 so that scores and logits are
    of order 1, the residual projections at 0.02, every bias at 0.02 and
    every LayerNorm gain at 1 +- 0.1 (the blocks' outlier channels
    ``OUTLIER_GAIN`` times that), so that no bias or gain is a no-op the
    comparison could miss."""
    D, C, P = cfg["hidden_size"], cfg["num_channels"], cfg["patch_size"]
    H, K = cfg["intermediate_size"], cfg["num_classes"]
    wide = D ** -0.5
    ln = lambda n: [(f"{n}.weight", (D,), 0.1, 1.0),
                    (f"{n}.bias", (D,), 0.02, 0.0)]
    vit = [("patch_embed.proj.weight", (D, C, P, P),
            (2.0 / (C * P * P + D)) ** 0.5, 0.0),
           ("patch_embed.proj.bias", (D,), 0.02, 0.0),
           ("cls_token", (1, 1, D), 0.02, 0.0)]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}"
        vit += ln(f"{b}.norm1")
        vit += [(f"{b}.attn.qkv.weight", (3 * D, D), wide, 0.0),
                (f"{b}.attn.qkv.bias", (3 * D,), 0.02, 0.0),
                (f"{b}.attn.proj.weight", (D, D), 0.02, 0.0),
                (f"{b}.attn.proj.bias", (D,), 0.02, 0.0)]
        vit += ln(f"{b}.norm2")
        vit += [(f"{b}.mlp.fc1.weight", (H, D), 0.02, 0.0),
                (f"{b}.mlp.fc1.bias", (H,), 0.02, 0.0),
                (f"{b}.mlp.fc2.weight", (D, H), 0.02, 0.0),
                (f"{b}.mlp.fc2.bias", (D,), 0.02, 0.0)]
    vit += ln("norm")
    vit += [("head.weight", (K, D), wide, 0.0), ("head.bias", (K,), 0.02, 0.0)]
    fus = []
    for e in range(cfg["multi_scale_enc_depth"]):
        for layer in range(cfg["cross_attn_depth"]):
            base = f"multi_scale_transformers.{e}.cross_attn_layers.{layer}"
            for j in range(4):
                if j in (0, 2):   # PreNorm(CrossAttention): 's', then 'l'
                    fus += ln(f"{base}.{j}.norm")
                    fus += [(f"{base}.{j}.fn.{w}.weight", (D, D), wide, 0.0)
                            for w in ("wq", "wk", "wv", "proj")]
                    fus += [(f"{base}.{j}.fn.proj.bias", (D,), 0.02, 0.0)]
                else:             # the LayerNorms after each direction
                    fus += ln(f"{base}.{j}")
    for h in ("mlp_head_cxr", "mlp_head_enh"):
        fus += [(f"{h}.0.weight", (K, D), wide, 0.0),
                (f"{h}.0.bias", (K,), 0.02, 0.0)]
    return {"cxr": vit, "enh": list(vit), "fus": fus}


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """The seeded fp32 weights of ``param_spec`` on ``device``, from one
    draw of ``gen``: {"cxr": {name: tensor}, "enh": ..., "fus": ...}."""
    spec = param_spec(cfg)
    total = sum(math.prod(s) for part in spec.values() for _, s, _, _ in part)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for part, leaves in spec.items():
        out[part] = {}
        for name, shape, std, mean in leaves:
            n = math.prod(shape)
            t = (flat[off:off + n].view(shape) * std + mean).contiguous()
            if name.endswith(("norm1.weight", "norm2.weight")):
                t[::OUTLIER_STRIDE] *= OUTLIER_GAIN
            out[part][name] = t
            off += n
    return out


def make_inputs(cfg: dict, traffic: dict, gen: torch.Generator,
                device) -> dict:
    """A pool of ``traffic["pool"]`` distinct seeded batches: normalised
    NHWC images of both views in the served dtype, and labels."""
    B, S, C = traffic["batch"], traffic["img_size"], cfg["num_channels"]
    dt = getattr(torch, traffic["dtype"])
    n = traffic["pool"]
    imgs = torch.randn(2, n, B, S, S, C, generator=gen, device=device,
                       dtype=torch.float32).to(dt)
    labels = torch.randint(0, cfg["num_classes"], (n, B), generator=gen,
                           device=device)
    return {"cxr": imgs[0], "enh": imgs[1], "labels": labels}


# ----------------------------------------------------------- precision

@contextlib.contextmanager
def fp32_exact():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


E4M3_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one absmax scale, back in fp32."""
    s = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Fp8MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_fp8(a) @ to_fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = to_fp8(g)
        return g8 @ to_fp8(b).mT, to_fp8(a).mT @ g8


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8MM.apply(a, b)


PRECISIONS = {"fp32": plain_mm, "fp8": fp8_mm}


# ----------------------------------------------------------- the model

def sincos_2d(gh: int, gw: int, dim: int, device) -> torch.Tensor:
    """MoCo v3's fixed table (1, 1 + gh*gw, dim), the CLS row zero."""
    gx, gy = torch.meshgrid(torch.arange(gw, dtype=torch.float64),
                            torch.arange(gh, dtype=torch.float64),
                            indexing="ij")
    d = dim // 4
    omega = 1.0 / 10000.0 ** (torch.arange(d, dtype=torch.float64) / d)
    ow = gx.flatten()[:, None] * omega[None]
    oh = gy.flatten()[:, None] * omega[None]
    pe = torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)
    pe = torch.cat([torch.zeros(1, dim, dtype=torch.float64), pe], 0)
    return pe[None].float().to(device)


def _lin(mm, x, w, b=None):
    y = mm(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], -1)
    return y if b is None else y + b


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _mha(mm, q, k, v, heads: int):
    """q (B, Nq, D), k and v (B, N, D) -> (B, Nq, D)."""
    B, Nq, D = q.shape
    d = D // heads
    q, k, v = (t.reshape(B, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    s = mm(q, k.transpose(-1, -2)) * d ** -0.5
    o = mm(torch.softmax(s, -1), v)
    return o.transpose(1, 2).reshape(B, Nq, D)


def vit(p: dict, cfg: dict, imgs: torch.Tensor, mm=plain_mm):
    """NHWC images -> (tokens (B, N+1, D), logits (B, classes)), fp32."""
    D, P, heads = cfg["hidden_size"], cfg["patch_size"], \
        cfg["num_attention_heads"]
    B, S = imgs.shape[0], imgs.shape[1]
    g = S // P
    cols = F.unfold(imgs.float().permute(0, 3, 1, 2), P, stride=P)
    x = _lin(mm, cols.transpose(1, 2), p["patch_embed.proj.weight"]
             .reshape(D, -1), p["patch_embed.proj.bias"])
    x = torch.cat([p["cls_token"].expand(B, 1, D), x], 1)
    x = x + sincos_2d(g, g, D, x.device)
    for i in range(cfg["num_hidden_layers"]):
        b = lambda n: p[f"blocks.{i}.{n}"]
        h = _ln(x, b("norm1.weight"), b("norm1.bias"), 1e-6)
        q, k, v = _lin(mm, h, b("attn.qkv.weight"),
                       b("attn.qkv.bias")).chunk(3, -1)
        x = x + _lin(mm, _mha(mm, q, k, v, heads), b("attn.proj.weight"),
                     b("attn.proj.bias"))
        h = _ln(x, b("norm2.weight"), b("norm2.bias"), 1e-6)
        h = F.gelu(_lin(mm, h, b("mlp.fc1.weight"), b("mlp.fc1.bias")))
        x = x + _lin(mm, h, b("mlp.fc2.weight"), b("mlp.fc2.bias"))
    tokens = _ln(x, p["norm.weight"], p["norm.bias"], 1e-6)
    return tokens, _lin(mm, tokens[:, 0], p["head.weight"], p["head.bias"])


def _direction(p: dict, pre: str, post: str, own, other, heads: int, mm):
    """One direction of the cross-attention layer: the fused CLS row of
    ``own`` (B, D) after the outer residual."""
    seq = torch.cat([own[:, :1], other[:, 1:]], 1)
    xn = _ln(seq, p[f"{pre}.norm.weight"], p[f"{pre}.norm.bias"], 1e-5)
    q = _lin(mm, xn[:, :1], p[f"{pre}.fn.wq.weight"])
    k = _lin(mm, xn, p[f"{pre}.fn.wk.weight"])
    v = _lin(mm, xn, p[f"{pre}.fn.wv.weight"])
    y = _lin(mm, _mha(mm, q, k, v, heads), p[f"{pre}.fn.proj.weight"],
             p[f"{pre}.fn.proj.bias"])
    cal = own[:, :1] + y
    out = _ln(cal, p[f"{post}.weight"], p[f"{post}.bias"], 1e-6)
    return own[:, 0] + out[:, 0]


def fusion(p: dict, cfg: dict, tok_c, tok_e, mm=plain_mm):
    """The CA head (one encoder of one layer, the defaults) -> (B, classes):
    the CXR CLS over the Enh patches ('s', LayerNorm 3), the Enh CLS over
    the CXR patches ('l', LayerNorm 1), each pooled through its head."""
    if cfg["multi_scale_enc_depth"] != 1 or cfg["cross_attn_depth"] != 1:
        raise ValueError("the reference covers the default fusion head: one "
                         "encoder of one cross-attention layer")
    base = "multi_scale_transformers.0.cross_attn_layers.0"
    heads = cfg["fusion_heads"]
    c = _direction(p, f"{base}.0", f"{base}.3", tok_c, tok_e, heads, mm)
    e = _direction(p, f"{base}.2", f"{base}.1", tok_e, tok_c, heads, mm)
    return (_lin(mm, c, p["mlp_head_cxr.0.weight"], p["mlp_head_cxr.0.bias"])
            + _lin(mm, e, p["mlp_head_enh.0.weight"],
                   p["mlp_head_enh.0.bias"]))


def decision(params: dict, cfg: dict, xc, xe, mm=plain_mm):
    """The decision logits (B, classes): fusion head + both branch heads."""
    tc, lc = vit(params["cxr"], cfg, xc, mm)
    te, le = vit(params["enh"], cfg, xe, mm)
    return fusion(params["fus"], cfg, tc, te, mm) + lc + le


def serve_logits(params: dict, cfg: dict, xc, xe, rows: int,
                 precision: str = "fp32") -> torch.Tensor:
    """``decision`` over a batch in blocks of ``rows`` images, no autograd."""
    mm = PRECISIONS[precision]
    with torch.no_grad(), fp32_exact():
        return torch.cat([decision(params, cfg, xc[i:i + rows],
                                   xe[i:i + rows], mm)
                          for i in range(0, xc.shape[0], rows)])


# -------------------------------------------------------- training steps

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def train_steps(params: dict, cfg: dict, batches: list, lr: float,
                rows: int, precision: str = "fp32") -> dict:
    """``len(batches)`` steps of the fusion step with every weight trained:
    the decision logits, mean cross-entropy over the batch, the gradients
    (accumulated over blocks of ``rows`` images) and one Adam step
    (torch's defaults: betas 0.9/0.999, eps 1e-8, no weight decay), from
    copies of ``params``. ``precision`` "fp32"; "fp8", every product with
    fp8 operands; "bf16_state", the weights and Adam's moments kept in
    bf16 (rounded from the start and after every update). Returns the
    loss of each step, the decision logits of the first, and by
    "part.name" each leaf's gradient at step 1 and its change over all
    the steps."""
    mm = plain_mm if precision == "bf16_state" else PRECISIONS[precision]
    keep = ((lambda t: t.to(torch.bfloat16).float())
            if precision == "bf16_state" else (lambda t: t))
    names = [(part, n) for part in ("cxr", "enh", "fus")
             for n in params[part]]
    p0 = [params[a][n].detach().float() for a, n in names]
    leaves = [keep(t.clone()).requires_grad_() for t in p0]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    b1, b2 = ADAM_BETAS
    losses, grad1, logits1 = [], None, None
    with fp32_exact():
        for step, (xc, xe, y) in enumerate(batches, 1):
            tree = {"cxr": {}, "enh": {}, "fus": {}}
            for (a, n), t in zip(names, leaves):
                tree[a][n] = t
            B = xc.shape[0]
            total, outs = 0.0, []
            for t in leaves:
                t.grad = None
            for i in range(0, B, rows):
                out = decision(tree, cfg, xc[i:i + rows], xe[i:i + rows], mm)
                loss = F.cross_entropy(out, y[i:i + rows].long(),
                                       reduction="sum") / B
                loss.backward()
                total += loss.item()
                outs.append(out.detach())
            losses.append(total)
            grads = [t.grad for t in leaves]
            if step == 1:
                grad1 = [g.clone() for g in grads]
                logits1 = torch.cat(outs)
            with torch.no_grad():
                for t, g, mt, vt in zip(leaves, grads, m, v):
                    mt.mul_(b1).add_(g, alpha=1 - b1)
                    vt.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vt / (1 - b2 ** step)).sqrt_().add_(ADAM_EPS)
                    t.addcdiv_(mt, denom, value=-lr / (1 - b1 ** step))
                    for x in (t, mt, vt):
                        x.copy_(keep(x))
    keys = [f"{a}.{n}" for a, n in names]
    return {"losses": losses, "logits": logits1,
            "grads": dict(zip(keys, grad1)),
            "deltas": {k: t.detach() - t0
                       for k, t, t0 in zip(keys, leaves, p0)}}
