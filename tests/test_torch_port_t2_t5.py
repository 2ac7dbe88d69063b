"""T2 (``attn_rolling``) and T5 (``staged_bwd``) on K1's and K5's
asynchronous cores, on the CPU: the Python mirrors of their walks and plans
(``attn_variants.unit_walk``, ``rolling_plan``, ``staged_plan``) against
the constants and formulas of csrc/attn_rolling.cu and
csrc/attn_bwd_staged.cuh, and a model of each core's ring protocol (the
producer's fills, the consumer warps' deferred tiles, the mbarriers'
arrivals) that must cover every tile once and never stall. Their kernels
run only on the card (``tests/test_torch_port_cuda.py``: equal to K1 / K5
and to their former designs bit for bit); their plain versions are held
against the JAX tools in ``tests/test_torch_port_variants_attn.py``."""
from __future__ import annotations

import random
import re

import pytest

from mfvit_tpu_torch.ops import attn_variants as av
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.ops import fused_attn as fa
from mfvit_tpu_torch.tools import core_trials

_ROLL = (build.CSRC / "attn_rolling.cu").read_text()
_STAGED = (build.CSRC / "attn_bwd_staged.cuh").read_text()
_BWD = (build.CSRC / "fused_attn_bwd.cu").read_text()
_WMMA = (build.CSRC / "attn_rolling_wmma.cu").read_text()
SMEM = 232448  # a block's shared memory on an H100


def test_rolling_plan_constants_are_the_c_sources():
    """RollCore's warps by head_dim, its passes, its slot layout (q beside
    K and V where two such slots fit), the takers bound and the key-tile
    counts are the ones ``rolling_plan`` mirrors."""
    for name, table in (("W", av.ROLL_WARPS), ("PASSES", av.ROLL_PASSES)):
        m = re.search(r"int %s = DH == 128 \? (\d+) : (\d+);" % name, _ROLL)
        assert table == {32: int(m.group(2)), 64: int(m.group(2)),
                         128: int(m.group(1))}
    assert f"constexpr int SMEM_MAX = {av.SMEM_MAX};" in _ROLL
    assert "QS = 2 * 3 * PART * 2 + 4 * 8 <= SMEM_MAX;" in _ROLL
    assert "PARTS = QS ? 3 : 2;" in _ROLL
    assert "SMEM = 2 * SLOT_BYTES + 4 * 8;" in _ROLL
    assert "LD = DH + 8;" in _ROLL
    assert "const int Wt = W < T ? W : T;" in _ROLL
    keys = [8 * int(n) for n in re.findall(r"return launch<DH, (\d+)>", _ROLL)]
    assert tuple(keys) == av.KEYS


def test_staged_plan_constants_are_the_c_sources():
    """T5's warps and takers bound, its ring (K5's AsyncBwd, as
    ``fused_attn._bwd_plan`` mirrors it) and its key-tile counts."""
    assert re.search(r"static constexpr int W = (\d+);", _STAGED).group(
        1) == str(av.STAGED_WARPS)
    assert "struct StagedBwd : AsyncBwd<DH, NKT>" in _STAGED
    assert "const int Wt = W < (S - 1) * T ? W : (S - 1) * T;" in _STAGED
    assert "if constexpr (C::S < 2)" in _STAGED
    keys = [8 * int(n) for n in re.findall(r"return launch<DH, (\d+)>",
                                           _STAGED)]
    assert tuple(keys) == fa.BWD_KEYS


@pytest.mark.parametrize("src", ["roll", "staged"])
def test_unit_walk_is_the_c_walk(src):
    """Both cores find a block's i-th pair as ``unit_walk`` does: unit bid
    + (i / cb) * grid, image (unit / heads) * cb + i % cb, head unit %
    heads; the grid is min(units, SMs) blocks of B / cb * heads units."""
    text = _ROLL if src == "roll" else _STAGED
    i = "i" if src == "roll" else "pi"
    assert (f"(size_t)((bid + {i} / cb * grid) / heads * cb + {i} % cb)"
            in text)
    assert f"(bid + {i} / cb * grid) % heads * DH" in text
    assert "const int units = B / cb * heads" in text
    assert "units < sms ? units : sms" in text
    assert ("const int mine = units > bid ? ((units - 1 - bid) / grid + 1)"
            " * cb : 0;") in text


WALKS = [(B, H, cb, grid) for B, H, cb in [(8, 12, 1), (8, 12, 2),
                                          (8, 12, 8), (3, 12, 3),
                                          (6, 3, 2), (256, 12, 16),
                                          (256, 12, 4)]
         for grid in (1, 7, 132) if grid <= B // cb * H]


@pytest.mark.parametrize("B,H,cb,grid", WALKS)
def test_unit_walk_covers_every_pair_once(B, H, cb, grid):
    """Every (image, head) pair of the batch falls to exactly one block;
    each block's pairs come in units of cb images of one head, in order,
    and adjacent blocks start on adjacent heads of one group."""
    walk = av.unit_walk(B, H, cb, grid)
    pairs = [p for blk in walk for p in blk]
    assert sorted(pairs) == [(b, h) for b in range(B) for h in range(H)]
    for bid, blk in enumerate(walk):
        assert len(blk) % cb == 0
        for u in range(0, len(blk), cb):
            unit = blk[u:u + cb]
            assert {h for _, h in unit} == {unit[0][1]}
            assert [b for b, _ in unit] == list(range(unit[0][0],
                                                      unit[0][0] + cb))
        assert blk[0] == (bid // H * cb, bid % H)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("N", [50, 197, 208])
def test_the_rings_fit_a_block_at_every_head_dim(dh, N):
    """T2's two slots (q, K and V, or K and V at head_dim 128 past 128
    keys) and T5's K5 ring of at least two slots fit 232,448 bytes."""
    roll = av.rolling_plan(N, dh)
    part = roll.keys * (dh + 8) * 2
    assert roll.slot_bytes == (3 if roll.q_staged else 2) * part
    assert roll.smem == 2 * roll.slot_bytes + 32 <= SMEM
    assert roll.q_staged == (2 * 3 * part + 32 <= SMEM)
    assert roll.q_staged or (dh == 128 and roll.keys == 208)
    assert roll.takers == min(av.ROLL_WARPS[dh], -(-N // 16))
    staged = av.staged_plan(N, dh)
    assert staged.smem <= SMEM and 2 <= staged.slots <= 4
    assert staged.takers == min(av.STAGED_WARPS,
                                (staged.slots - 1) * -(-N // 16))


@pytest.mark.parametrize("plan", [av.rolling_plan, av.staged_plan])
def test_the_plans_refuse_head_dim_128_past_208(plan):
    with pytest.raises(ValueError, match="N"):
        plan(209, 128)
    assert plan(256, 64).keys == 256


def _c_args(name: str, text: str) -> str:
    """The kinds of a C entry point's parameters: P pointer, I int, F
    float."""
    m = re.search(r"MFV_API int %s\((.*?)\)\s*\{" % name, text, re.S)
    args = [a.strip() for a in m.group(1).split(",")]
    return "".join("P" if "*" in a else "F" if a.startswith("float")
                   else "I" for a in args)


@pytest.mark.parametrize("name,text", [
    ("mfv_attn_rolling", _ROLL), ("mfv_attn_rolling_wmma", _WMMA),
    ("mfv_staged_bwd", _BWD), ("mfv_staged_bwd_former", _BWD)])
def test_the_new_entries_argtypes_match_their_signatures(name, text):
    kinds = {build._P: "P", build._I: "I", build._F: "F"}
    assert "".join(kinds[t] for t in build.SIGNATURES[name]) == _c_args(
        name, text)


def test_t2_drops_the_statistics_scratch():
    """T2 on K1's chain takes no LN statistics; its former design does."""
    assert len(build.SIGNATURES["mfv_attn_rolling_wmma"]) == len(
        build.SIGNATURES["mfv_attn_rolling"]) + 1
    assert "stats" not in _ROLL.split("MFV_API int mfv_attn_rolling(")[1]


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


def _rolling_model(images: int, T: int, Wt: int, seed: int) -> list:
    """One block of T2's core: a producer filling a ring of two slots
    (image i after image i - 2 was handed back), Wt warps over the
    flattened tiles, each running the scores of its next tile before the P
    V of its deferred one, which hands its slot back. Returns the P V count
    of each tile."""
    filled, released = [0], [0] * images  # images filled; P Vs an image
    pv = [0] * (images * T)
    live = []

    def producer():
        i = filled[0]
        if i >= images or (i >= 2 and released[i - 2] < T):
            return False
        filled[0] += 1
        live.append(i)
        assert len([j for j in live if released[j] < T]) <= 2
        return True

    def warp(w):
        tasks = list(range(w, images * T, Wt))
        state = {"next": 0, "deferred": None}

        def finish():
            d = state["deferred"]
            pv[d] += 1
            released[d // T] += 1
            state["deferred"] = None

        def act():
            if state["next"] < len(tasks):
                k = tasks[state["next"]]
                i = k // T
                if filled[0] <= i:  # waiting for image i
                    # its slot's last round (image i - 2) has landed
                    assert filled[0] >= i - 1
                    return False
                if state["deferred"] is not None:
                    assert i - state["deferred"] // T <= 1
                    finish()
                state["deferred"] = k
                state["next"] += 1
                return True
            if state["deferred"] is not None:
                finish()
                return True
            return False
        return act

    actors = [producer] + [warp(w) for w in range(Wt)]
    _run(actors, random.Random(seed),
         lambda: all(r == T for r in released))
    return pv


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("N,dh,images", [(197, 32, 8), (50, 32, 9),
                                         (208, 128, 6), (197, 64, 16),
                                         (16, 32, 5)])
def test_the_rolling_ring_runs_every_tile_once(N, dh, images, seed):
    """T2's protocol at the plan's warps: every tile's P V runs once, at
    most two images' rows are live, a warp waits only one round ahead of
    its slot's last fill, and nothing stalls."""
    T = -(-N // 16)
    pv = _rolling_model(images, T, av.rolling_plan(N, dh).takers, seed)
    assert pv == [1] * (images * T)


def _staged_model(pairs: int, T: int, S: int, Wt: int, seed: int) -> dict:
    """One block of T5's core: K5's producer (stage 2 pi: K and V; 2 pi +
    1: Q and dO; stage i after stage i - S was handed back), Wt warps over
    K5's tasks (a pair's T query tiles, then its T
    key tiles), a query tile's gradients deferred past the warp's next
    query tile's scores, a key tile first finishing the deferred one and
    waiting for its pair's statistics (the pair's query gradients). Returns
    the times each task ran."""
    stages = 2 * pairs
    filled, arrivals = [0], [0] * stages
    ready = [0] * pairs  # query tiles with their statistics written
    keys_done = [0] * pairs
    ran = {}

    def producer():
        i = filled[0]
        if i >= stages or (i >= S and arrivals[i - S] < T):
            return False
        filled[0] += 1
        return True

    def warp(w):
        tasks = list(range(w, stages * T, Wt))
        state = {"next": 0, "deferred": None}

        def finish():
            d = state["deferred"]
            pi = d // (2 * T)
            # the statistics buffer pi % S is free: pair pi - S's key
            # tiles are all done
            assert pi < S or keys_done[pi - S] == T
            ran[d] = ran.get(d, 0) + 1
            ready[pi] += 1
            arrivals[2 * pi] += 1
            state["deferred"] = None

        def act():
            if state["next"] >= len(tasks):
                if state["deferred"] is not None:
                    finish()
                    return True
                return False
            k = tasks[state["next"]]
            pi, r = divmod(k, 2 * T)
            keys = r >= T
            i = 2 * pi + keys
            if keys and state["deferred"] is not None:
                finish()
                return True
            if filled[0] <= i:
                assert filled[0] >= i - S + 1  # one round from the last
                return False
            if keys:
                if ready[pi] < T:
                    # the buffer's last round (pair pi - S) is complete
                    assert pi < S or ready[pi - S] == T
                    return False
                ran[k] = ran.get(k, 0) + 1
                keys_done[pi] += 1
                arrivals[i] += 1
            else:
                if state["deferred"] is not None:
                    d = state["deferred"]
                    assert i - 2 * (d // (2 * T)) <= S - 1
                    finish()
                state["deferred"] = k
            state["next"] += 1
            return True
        return act

    actors = [producer] + [warp(w) for w in range(Wt)]
    _run(actors, random.Random(seed), lambda: all(a == T for a in arrivals))
    return ran


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("N,dh,pairs", [(197, 32, 6), (50, 32, 7),
                                        (208, 128, 5), (197, 64, 8),
                                        (50, 128, 4), (16, 32, 5)])
def test_the_staged_ring_runs_every_task_once(N, dh, pairs, seed):
    """T5's protocol at the plan's ring and warps: every query and key
    tile runs once, a statistics buffer is rewritten only after the key
    tiles that read it, every wait stays within one round, nothing
    stalls."""
    plan = av.staged_plan(N, dh)
    T = -(-N // 16)
    ran = _staged_model(pairs, T, plan.slots, plan.takers, seed)
    assert ran == {k: 1 for k in range(2 * pairs * T)}


@pytest.mark.parametrize("model", ["rolling", "staged"])
def test_the_models_stall_past_their_bounds(model):
    """The takers bounds are what keep the rings moving: T2 with T + 1
    warps taking tiles and T5 with (S - 1) * T + 1 stall (a warp waits
    for a stage whose slot its own deferred tile holds)."""
    with pytest.raises(AssertionError, match="stalled|assert"):
        for seed in range(20):
            if model == "rolling":
                _rolling_model(8, 2, 3, seed)
            else:
                _staged_model(6, 2, 2, 3, seed)


@pytest.mark.parametrize("tag", sorted(core_trials.TRIALS))
def test_core_trials_trees_set_the_constants(tmp_path, tag):
    """``tools/core_trials.py``'s copies: only the sources K1, K5, T2 and T5
    build from, their library binding only what those define, T2's warps
    and passes and T5's warps as the trial says; the "tree" trial is this
    checkout's setting, so its copy leaves the two sources as they are."""
    core_trials.make_tree(build.CSRC.parents[1], tmp_path,
                          core_trials.TRIALS[tag])
    csrc = tmp_path / "mfvit_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == core_trials.SOURCES
    (w, w128), (passes, passes128), staged_w = core_trials.TRIALS[tag]
    roll = (csrc / "attn_rolling.cu").read_text()
    assert f"int W = DH == 128 ? {w128} : {w};" in roll
    assert f"int PASSES = DH == 128 ? {passes128} : {passes};" in roll
    staged = (csrc / "attn_bwd_staged.cuh").read_text()
    assert f"static constexpr int W = {staged_w};" in staged
    if tag == "tree":
        assert roll == _ROLL and staged == _STAGED
        assert (w, w128) == (av.ROLL_WARPS[32], av.ROLL_WARPS[128])
        assert (passes, passes128) == (av.ROLL_PASSES[32],
                                       av.ROLL_PASSES[128])
        assert staged_w == av.STAGED_WARPS
    assert "SIGNATURES = {k: v for k, v in SIGNATURES.items()" in (
        tmp_path / "mfvit_tpu_torch" / "ops" / "build.py").read_text()
