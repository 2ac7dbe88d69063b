"""T1 (``attn_pairs``) on K1's four launches around a pair core, on the CPU:
the Python mirrors of its plan and walk (``attn_variants.pairs_plan``,
``pair_walk``) against the constants and formulas of csrc/attn_pairs.cu,
the per-tile header it shares with T2 (csrc/attn_tile.cuh), a model
of its ring protocol (a producer staging one head of both images of a pair
into a slot, consumer warps deferring a tile's P V past the next tile's
softmax, the one-slot ring finishing the deferred tile before a new pair)
that must run every image tile once and never stall, the C entry points'
argument types, the former design's refusals and ``core_trials --set t1``'s
trees. Its kernels run only on the card (``tests/test_torch_port_cuda.py``:
equal to K1 and to ``attn_pairs_wmma`` bit for bit); its plain version is
held against the JAX tool in ``tests/test_torch_port_variants_attn.py``."""
from __future__ import annotations

import random
import re

import pytest
import torch

from mfvit_tpu_torch.ops import attn_variants as av
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.tools import core_trials

_PAIRS = (build.CSRC / "attn_pairs.cu").read_text()
_WMMA = (build.CSRC / "attn_pairs_wmma.cu").read_text()
_TILE = (build.CSRC / "attn_tile.cuh").read_text()
SMEM = 232448  # a block's shared memory on an H100


def test_pairs_plan_constants_are_the_c_source():
    """PairCore's warps, passes, images a tile and deferral by head_dim, its
    ring rule and formula, the takers bound and the key-tile counts are the
    ones ``pairs_plan`` mirrors."""
    for name, table in (("W", av.PAIRS_WARPS), ("PASSES", av.PAIRS_PASSES),
                        ("NI", av.PAIRS_IMAGES)):
        m = re.search(r"static constexpr int %s = (?:DH == 128 \? (\d+) : )?"
                      r"(\d+);" % name, _PAIRS)
        assert table == {32: int(m.group(2)), 64: int(m.group(2)),
                         128: int(m.group(1) or m.group(2))}
    defer = re.search(r"static constexpr bool DEFER = (\w+);", _PAIRS)
    assert av.PAIRS_DEFER == (defer.group(1) == "true")
    assert f"constexpr int SMEM_MAX = {av.SMEM_MAX};" in _PAIRS
    assert ("return slots * 2 * parts * part * 2 + 2 * slots * 8;"
            in _PAIRS)
    assert ("pair_ring(PART, 2, 3) <= SMEM_MAX || pair_ring(PART, 2, 2) <= "
            "SMEM_MAX ? 2 : 1;") in _PAIRS
    assert "QS = pair_ring(PART, S, 3) <= SMEM_MAX;" in _PAIRS
    assert "SMEM = pair_ring(PART, S, PARTS);" in _PAIRS
    assert av.PAIRS_RINGS == ((2, 3), (2, 2), (1, 3), (1, 2))
    assert "PART = NK * LD;" in _PAIRS and "LD = DH + 8;" in _PAIRS
    assert "SLOT = 2 * IMAGE;" in _PAIRS
    assert "const int TP = 2 * T / NI;" in _PAIRS
    assert "const int Wt = W < TP ? W : TP;" in _PAIRS
    assert "mbar_init(&empty[s], 2 * T);" in _PAIRS
    keys = [8 * int(n) for n in re.findall(r"return launch<DH, (\d+)>",
                                           _PAIRS)]
    assert tuple(keys) == av.KEYS


@pytest.mark.parametrize("part,slots,parts", [(100, 2, 3), (16640, 1, 2),
                                              (29952, 2, 2)])
def test_the_ring_formula_counts_both_images_and_the_barriers(part, slots,
                                                              parts):
    """``pair_ring_bytes`` (part in bytes) is the C side's ``pair_ring``
    (part in bf16): each slot two images of ``parts`` parts, then a full
    and an empty barrier of 8 bytes a slot."""
    half = part // 2
    c_side = slots * 2 * parts * half * 2 + 2 * slots * 8
    assert av.pair_ring_bytes(2 * half, slots, parts) == c_side
    assert c_side == slots * 2 * parts * 2 * half + 16 * slots


# head_dim, N -> (keys, slots, q staged, one image's part, pair slot):
# the pair slots at vit_small's N = 197 and the neighbouring sizes
PLANS = {(32, 50): (64, 2, True, 5120, 30720),
         (32, 197): (208, 2, True, 16640, 99840),
         (32, 208): (208, 2, True, 16640, 99840),
         (32, 256): (256, 2, False, 20480, 81920),
         (64, 50): (64, 2, True, 9216, 55296),
         (64, 197): (208, 1, True, 29952, 179712),
         (64, 208): (208, 1, True, 29952, 179712),
         (64, 256): (256, 1, True, 36864, 221184),
         (128, 50): (64, 2, True, 17408, 104448),
         (128, 197): (208, 1, False, 56576, 113152 * 2),
         (128, 208): (208, 1, False, 56576, 226304)}


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("N", [50, 197, 208, 256])
def test_pairs_plan_slots_and_parts(dh, N):
    """The slots and parts at head_dim 32/64/128: two slots of q, K and V
    at head_dim 32 (2 x 99,840 bytes at 197 tokens), one at head_dim 64
    (two of K and V would need 239,616), one of K and V at head_dim 128
    (226,304; q's fragments from device memory); head_dim 128 past 208
    tokens refused."""
    if (dh, N) not in PLANS:
        with pytest.raises(ValueError, match="passes"):
            av.pairs_plan(N, dh)
        return
    plan = av.pairs_plan(N, dh)
    keys, slots, qs, part, slot = PLANS[dh, N]
    assert (plan.keys, plan.slots, plan.q_staged, plan.part_bytes,
            plan.slot_bytes) == (keys, slots, qs, part, slot)
    assert part == keys * (dh + 8) * 2
    assert plan.smem == slots * slot + 16 * slots <= SMEM
    if dh == 64 and N == 197:
        assert 2 * 2 * 2 * part == 239616 > SMEM  # two slots of K and V
    if dh == 32 and N == 197:
        assert 2 * slot == 199680
    T = -(-N // 16)
    TP = 2 * T // plan.images
    assert plan.takers == min(plan.warps, TP)
    # the block's threads: the consumer warps and the producer
    assert (plan.warps + 1) * 32 <= 1024


def test_pairs_plan_refuses_what_the_kernel_does_not_take():
    for N, dh in ((257, 32), (0, 32), (197, 16)):
        with pytest.raises(ValueError, match="attn_pairs"):
            av.pairs_plan(N, dh)


def test_the_pair_walk_is_the_c_walk():
    """T1's blocks find a block's i-th image as ``unit_walk`` does and take
    cb / 2 pairs a unit, images 2p and 2p + 1."""
    assert "(size_t)((bid + i / cb * grid) / heads * cb + i % cb)" in _PAIRS
    assert "(bid + i / cb * grid) % heads * DH" in _PAIRS
    assert "const int units = B / cb * heads" in _PAIRS
    assert "units < sms ? units : sms" in _PAIRS
    assert ("const int mine = units > bid ? ((units - 1 - bid) / grid + 1) "
            "* (cb / 2) : 0;") in _PAIRS
    assert "q_of(2 * p + j)" in _PAIRS
    assert "return 2 * p + (NI == 2 ? 0 : (k - p * TP) / T);" in _PAIRS
    assert "cb % 2 != 0" in _PAIRS.split("MFV_API int mfv_attn_pairs(")[1]


@pytest.mark.parametrize("B,H,cb,grid", [
    (8, 12, 2, 7), (8, 12, 4, 132), (8, 12, 8, 12), (256, 12, 4, 132),
    (256, 12, 8, 132), (6, 3, 2, 9), (6, 3, 2, 1), (16, 6, 8, 5)])
def test_the_pair_walk_covers_every_pair_once(B, H, cb, grid):
    """Every (image, head) pair falls to one block; a block's image pairs
    are adjacent images of one unit, in unit_walk's order."""
    walk = av.pair_walk(B, H, cb, grid)
    units = av.unit_walk(B, H, cb, grid)
    seen = []
    for blk, imgs in zip(walk, units):
        assert len(blk) == len(imgs) // 2
        for p, (a, b, h) in enumerate(blk):
            assert b == a + 1 and a % 2 == 0
            assert imgs[2 * p] == (a, h) and imgs[2 * p + 1] == (b, h)
            seen += [(a, h), (b, h)]
    assert sorted(seen) == [(b, h) for b in range(B) for h in range(H)]


def test_the_pair_walk_refuses_an_odd_cb():
    with pytest.raises(ValueError, match="even"):
        av.pair_walk(6, 3, 3, 2)


def _run(actors, rng, done) -> None:
    """Step the actors (callables returning True when they moved) in a
    random order until ``done()``; a sweep in which none moves is a stall."""
    while not done():
        order = list(actors)
        rng.shuffle(order)
        moved = False
        for act in order:
            moved |= act()
        assert moved, "the protocol stalled"


def _pairs_model(pairs: int, T: int, NI: int, S: int, Wt: int, defer: bool,
                 seed: int, boundary: bool = True) -> list:
    """One block of T1's pair core: a producer filling a ring of S pair
    slots (pair p after pair p - S was handed back: all its 2T image tiles
    arrived), Wt warps taking tiles k = w, w + Wt, ... of TP = 2T / NI a
    pair (NI images a tile). A warp, for each tile: on a one-slot ring
    (with ``boundary``) finishes a deferred tile of an earlier pair, waits
    for its pair's fill (parity alone: pair p - S's fill must have
    landed), computes the scores and softmax, then runs its deferred tile's
    P V (each of its image tiles arriving on the slot) and defers this tile
    (or, without ``defer``, runs its P V at once); at the end it finishes
    its deferred tile. Returns the P V count of each image tile."""
    TP = 2 * T // NI
    total = pairs * TP
    filled, released = [0], [0] * pairs
    pv = [0] * (pairs * 2 * T)

    def image_tiles(k):
        p, j = divmod(k, TP)
        if NI == 2:
            return [(2 * p + n) * T + j for n in range(2)]
        return [(2 * p + j // T) * T + j % T]

    def finish(k):
        for t in image_tiles(k):
            pv[t] += 1
            released[k // TP] += 1

    def producer():
        p = filled[0]
        if p >= pairs or (p >= S and released[p - S] < 2 * T):
            return False
        filled[0] += 1
        return True

    def warp(w):
        st = {"k": w, "deferred": None, "stage": "boundary"}

        def act():
            k, d = st["k"], st["deferred"]
            if k >= total:
                if d is None:
                    return False
                finish(d)
                st["deferred"] = None
                return True
            p = k // TP
            if st["stage"] == "boundary":
                if S == 1 and boundary and d is not None and d // TP != p:
                    finish(d)
                    st["deferred"] = None
                st["stage"] = "wait"
                return True
            if st["stage"] == "wait":
                if filled[0] <= p:
                    assert filled[0] >= p - S + 1, "a wait two rounds ahead"
                    return False
                st["stage"] = "softmax"
                return True
            if d is not None:
                finish(d)
            st["deferred"] = k
            if not defer:
                finish(k)
                st["deferred"] = None
            st["k"] += Wt
            st["stage"] = "boundary"
            return True
        return act

    _run([producer] + [warp(w) for w in range(Wt)], random.Random(seed),
         lambda: all(r == 2 * T for r in released))
    return pv


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("N,dh,pairs", [(197, 32, 4), (50, 32, 5),
                                        (256, 32, 3), (197, 64, 4),
                                        (128, 128, 3), (208, 128, 4),
                                        (16, 32, 5), (50, 128, 6)])
def test_the_pair_ring_runs_every_image_tile_once(N, dh, pairs, seed):
    """T1's protocol at the plan's slots, images a tile, deferral and
    takers (one and two pair slots): every image tile's P V runs once, a
    warp waits only one round ahead of its slot's last fill, and nothing
    stalls."""
    plan = av.pairs_plan(N, dh)
    T = -(-N // 16)
    pv = _pairs_model(pairs, T, plan.images, plan.slots, plan.takers,
                      plan.defer, seed)
    assert pv == [1] * (pairs * 2 * T)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("NI,defer", [(2, True), (1, True), (2, False)])
def test_every_grain_runs_at_the_takers_bound(S, NI, defer, seed):
    """The trials' grains ((i) pair tiles deferred, (ii) image tiles
    deferred, (iii) pair tiles undeferred) on either ring, at the bound the
    C side uses, Wt = min(W, 2T / NI), with W = 15 and T = 13 (N = 197)."""
    T = 13
    Wt = min(15, 2 * T // NI)
    pv = _pairs_model(3, T, NI, S, Wt, defer, seed)
    assert pv == [1] * (3 * 2 * T)


def test_the_models_fail_past_their_bounds():
    """More takers than a pair's tiles: a warp waits for pair p + 2 while
    it holds a deferred tile of pair p (a stall on two slots, or a wait two
    rounds ahead); on one slot, a deferred tile carried across a pair's
    boundary holds the slot the next pair needs."""
    with pytest.raises(AssertionError, match="stalled|two rounds"):
        for seed in range(20):
            _pairs_model(6, 2, 2, 2, 3, True, seed)
    with pytest.raises(AssertionError, match="stalled"):
        _pairs_model(3, 13, 2, 1, 11, True, 0, boundary=False)


def _c_args(name: str, text: str) -> str:
    """The kinds of a C entry point's parameters: P pointer, I int, F
    float."""
    m = re.search(r"MFV_API int %s\((.*?)\)\s*\{" % name, text, re.S)
    args = [a.strip() for a in m.group(1).split(",")]
    return "".join("P" if "*" in a else "F" if a.startswith("float")
                   else "I" for a in args)


@pytest.mark.parametrize("name,text", [("mfv_attn_pairs", _PAIRS),
                                       ("mfv_attn_pairs_wmma", _WMMA)])
def test_the_new_and_former_entries_argtypes_match_their_signatures(name,
                                                                    text):
    kinds = {build._P: "P", build._I: "I", build._F: "F"}
    assert "".join(kinds[t] for t in build.SIGNATURES[name]) == _c_args(
        name, text)


def test_t1_runs_k1s_four_launches_and_no_former_code():
    """T1 on K1's chain takes no LN statistics (its former design does); its
    source holds K1's LN pass and wgmma GEMMs around the pair core, and none
    of gemm_ln.cuh's or attn_core.cuh's stages; the pair core has no
    block-wide barrier past the barriers' set-up."""
    assert len(build.SIGNATURES["mfv_attn_pairs_wmma"]) == len(
        build.SIGNATURES["mfv_attn_pairs"]) + 1
    entry = _PAIRS.split("MFV_API int mfv_attn_pairs(")[1]
    assert "stats" not in entry
    for call in ("blk::launch_ln1(", "sm90::gemm<EPI_BIAS>(",
                 "sm90::gemm<EPI_BIAS_RESID>("):
        assert call in entry
    assert '#include "gemm_ln.cuh"' not in _PAIRS
    assert '#include "attn_tile.cuh"' in _PAIRS
    for stage in ("attn_block(", "attn_stage_k", "attn_stage_vt",
                  "attn_scores<", "attn_softmax<", "attn_pv_packed<"):
        assert stage not in _PAIRS and stage in _WMMA
    assert _PAIRS.count("__syncthreads();") == 1
    assert "cp_async_arrive(&full[slot]);" in _PAIRS
    assert "tile::stage_image<DH, NKT, C::PARTS>" in _PAIRS


@pytest.mark.parametrize("src", ["attn_pairs.cu", "attn_rolling.cu"])
def test_the_cores_share_the_tile_header_and_k1s_does_not(src):
    """T1's and T2's cores take their per-tile pieces from attn_tile.cuh
    (no copy of the score loop of their own); K1's asynchronous core and
    T4's staged core keep their own."""
    text = (build.CSRC / src).read_text()
    assert '#include "attn_tile.cuh"' in text
    assert "using TL = tile::Tile<DH, NKT, " in text
    for piece in ("TL::row_max(", "TL::exps(", "TL::pv(", "TL::store(",
                  "tile::load_q<DH, C::QS>("):
        assert piece in text
    assert "mma_bf16_16816" not in text and "expf(" not in text
    for own in ("attn_async.cu", "attn_staged.cu"):
        assert "attn_tile.cuh" not in (build.CSRC / own).read_text()
    for piece in ("stage_image", "load_q", "scores(", "row_max(",
                  "quad_max(", "exps(", "quad_sum(", "pv(", "store("):
        assert piece in _TILE


def _x(B, N, D, seed=0):
    return torch.randn(B, N, D, generator=torch.Generator().manual_seed(
        seed)).bfloat16()


REFUSED = {
    "odd cb": (dict(B=6, N=50, D=128), 4, 3, "must be even"),
    "cb not dividing B": (dict(B=6, N=50, D=128), 4, 4, "must divide B"),
    "head_dim 128 past 208": (dict(B=2, N=209, D=256), 2, 2, "N <= 208"),
    "heads not dividing D": (dict(B=2, N=50, D=128), 3, 2, "heads"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_former_design_refuses_what_t1_refuses(case):
    """``attn_pairs_wmma`` runs T1's argument checks first: every shape and
    cb that ``attn_pairs`` refuses it refuses with the same words (its own
    name), on any device."""
    shape, heads, cb, words = REFUSED[case]
    x = _x(**shape)
    D = shape["D"]
    w = [torch.ones(D), torch.zeros(D), torch.zeros(3 * D, D),
         torch.zeros(3 * D), torch.zeros(D, D), torch.zeros(D)]
    msgs = []
    for op in (av.attn_pairs, av.attn_pairs_wmma):
        with pytest.raises(ValueError, match=words) as e:
            op(x, *w, heads, 0.1, cb=cb)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0].replace("attn_pairs", "attn_pairs_wmma")


@pytest.mark.parametrize("tag", sorted(core_trials.PAIRS_TRIALS))
def test_core_trials_pairs_trees_set_the_constants(tmp_path, tag):
    """``tools/core_trials.py --set t1``'s copies: only the sources K1 and
    T1 build from, their library binding only what those define, T1's
    warps, passes, images a tile and deferral as the trial says; the "tree"
    trial is this checkout's setting, so its copy differs from the source
    only in spelling a constant out by head_dim."""
    core_trials.make_pairs_tree(build.CSRC.parents[1], tmp_path,
                                core_trials.PAIRS_TRIALS[tag])
    csrc = tmp_path / "mfvit_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == core_trials.PAIRS_SOURCES
    assert (csrc / "attn_tile.cuh").exists()
    (w, w128), (passes, passes128), (ni, ni128), defer = (
        core_trials.PAIRS_TRIALS[tag])
    text = (csrc / "attn_pairs.cu").read_text()
    assert f"int W = DH == 128 ? {w128} : {w};" in text
    assert f"int PASSES = DH == 128 ? {passes128} : {passes};" in text
    assert f"int NI = DH == 128 ? {ni128} : {ni};" in text
    assert f"bool DEFER = {'true' if defer else 'false'};" in text
    assert all(1 <= v <= 31 for v in (w, w128))
    if tag == "tree":
        assert re.sub(r"DH == 128 \? (\d+) : \1;", r"\1;", text) == _PAIRS
        assert (w, w128) == (av.PAIRS_WARPS[32], av.PAIRS_WARPS[128])
        assert (passes, passes128) == (av.PAIRS_PASSES[32],
                                       av.PAIRS_PASSES[128])
        assert (ni, ni128) == (av.PAIRS_IMAGES[32], av.PAIRS_IMAGES[128])
        assert defer == av.PAIRS_DEFER
    assert "SIGNATURES = {k: v for k, v in SIGNATURES.items()" in (
        tmp_path / "mfvit_tpu_torch" / "ops" / "build.py").read_text()


def test_the_trials_cover_the_three_grains():
    """The trials hold (i) pair tiles deferred, (ii) image tiles deferred
    and (iii) pair tiles undeferred, and both pass counts."""
    grains = {(ni[0], defer) for _, _, ni, defer
              in core_trials.PAIRS_TRIALS.values()}
    assert {(2, True), (1, True), (2, False)} <= grains
    assert {p[0] for _, p, _, _ in core_trials.PAIRS_TRIALS.values()} == {
        1, 2}


def test_ptxas_report_reads_each_instance_of_its_source():
    """Only the named source's section counts: the former design's kernel
    of the same name, in the next section, is left out."""
    log = """/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -c /r/csrc/attn_pairs.cu -o /w/attn_pairs.o
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117attn_pairs_kernelILi32ELi26EEEvPK13__nv_bfloat16PS1_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117attn_pairs_kernelILi32ELi26EEEvPK13__nv_bfloat16PS1_iiifi
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119attn_rolling_kernelILi32ELi26EEEvPK13__nv_bfloat16PS1_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119attn_rolling_kernelILi32ELi26EEEvPK13__nv_bfloat16PS1_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 384 bytes cmem[0]
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -c /r/csrc/attn_pairs_wmma.cu -o /w/attn_pairs_wmma.o
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117attn_pairs_kernelILi32ELi26EEEvPK13__nv_bfloat16PS1_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117attn_pairs_kernelILi32ELi26EEEvPK13__nv_bfloat16PS1_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 384 bytes cmem[0]
"""
    assert core_trials.ptxas_report(log, "attn_pairs_kernel",
                                    "attn_pairs.cu") == {
        "DH=32 NKT=26": {"stack": 8, "spill_stores": 12, "spill_loads": 16,
                         "registers": 168}}
