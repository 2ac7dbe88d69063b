"""T3 (``mlp_pipe``) on K2's wgmma tail and T4 (``attn_staged``) on K1's
asynchronous core, on the CPU: the Python mirrors of their plans and walks
(``mlp_variants.pipe_plan`` and ``check_pipe``, ``attn_variants.
staged_fwd_plan`` and ``unit_walk``) against the constants and formulas of
csrc/block_tail.cuh, csrc/mlp_pipe.cu and csrc/attn_staged.cu, and models
of each kernel's protocol: T3's ring read by two warpgroups in ping-pong
and T4's two-slot ring under its two groups' turns with each warp's
deferred P V, which must cover everything once and never stall. Their
kernels run only on the card (``tests/test_torch_port_cuda.py``: equal to
K2 / K1 and to their former designs bit for bit); their plain versions
are held against the JAX tools in ``tests/test_torch_port_variants.py``."""
from __future__ import annotations

import random
import re

import pytest

from mfvit_tpu_torch.ops import attn_variants as av
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.ops import fused_mlp as fm
from mfvit_tpu_torch.ops import mlp_variants as mv
from mfvit_tpu_torch.tools import bench_pipelined, core_trials

_TAIL = (build.CSRC / "block_tail.cuh").read_text()
_PIPE = (build.CSRC / "mlp_pipe.cu").read_text()
_FORMER_MLP = (build.CSRC / "mlp_variants.cu").read_text()
_STAGED = (build.CSRC / "attn_staged.cu").read_text()
_STAGED_WMMA = (build.CSRC / "attn_staged_wmma.cu").read_text()
SMEM = 232448  # a block's shared memory on an H100


def test_pipe_constants_are_the_c_sources():
    """The tile, the hidden chunk, setmaxnreg's pair, the widths and the
    shared-memory formula of block_tail.cuh's PIPE are ``pipe_plan``'s."""
    assert (f"constexpr int PIPE_ROWS = {mv.PIPE_ROWS}, PIPE_HC = "
            f"{mv.PIPE_HC};") in _TAIL
    assert (f"constexpr int PIPE_CONSUMER_REGS = {mv.PIPE_CONSUMER_REGS}, "
            f"PIPE_PRODUCER_REGS = {mv.PIPE_PRODUCER_REGS};") in _TAIL
    # two consumer warpgroups and the producer's fit the register file
    assert (2 * 128 * mv.PIPE_CONSUMER_REGS + 128 * mv.PIPE_PRODUCER_REGS
            <= 65536)
    assert ("return stages * STAGE + 2 * A_BYTES + 2 * TILE64 + (2 * stages "
            "+ 2) * 8 + 1024;") in _TAIL
    assert "static constexpr int A_BYTES = KD * TILE64;" in _TAIL
    assert "(PIPE == 2 && p.stages < D / 64)" in _TAIL
    widths = re.findall(r"case (\d+): return launch_tail<\d+, false, false, "
                        r"false, false, PIPE>", _TAIL)
    assert tuple(int(w) for w in widths) == mv.PIPE_WIDTHS
    assert "D % 128 == 0 && D <= 384" in _TAIL
    assert "float acc1[16];" in _TAIL and "float acc[P::NB][64];" in _TAIL


def test_mlp_pipe_routes_each_pair_of_the_set():
    """mfv_mlp_pipe takes exactly PIPE_SET: (64, 1) K2's tail, (128, 1)
    PIPE 1, (128, 2) PIPE 2."""
    routes = re.findall(r"if \(tm == (\d+) && splits == (\d+)\) return "
                        r"blk::(\w+)", _PIPE)
    assert [(int(a), int(b)) for a, b, _ in routes] == list(mv.PIPE_SET)
    assert [r for *_, r in routes] == ["launch_tail_d", "launch_pipe_d",
                                       "launch_pipe_d"]
    assert "launch_pipe_d<1>" in _PIPE and "launch_pipe_d<2>" in _PIPE


@pytest.mark.parametrize("D", [128, 256, 384, 512])
@pytest.mark.parametrize("tm,splits", list(mv.PIPE_SET))
def test_pipe_plan_fits_a_block(D, tm, splits):
    """At each width the ring, the two sub-tiles and the hidden tiles fit
    232,448 bytes, the accumulators a consumer thread holds fit its
    registers, and a ping-pong turn (D / 64 stages) fits the ring; tm=128
    is refused at D=512 (fc2's 256 accumulators a thread)."""
    if tm == mv.PIPE_ROWS and D not in mv.PIPE_WIDTHS:
        with pytest.raises(ValueError, match="registers"):
            mv.pipe_plan(D, 4 * D, tm, splits)
        assert D // 2 + mv.PIPE_FC1_REGS > mv.PIPE_ACC_BUDGET
        return
    plan = mv.pipe_plan(D, 4 * D, tm, splits)
    if tm == 64:
        assert plan == fm._plan(D, 4 * D)  # K2's own tail
        return
    assert plan.route == "pipe" and plan.smem <= SMEM
    assert plan.smem == mv._pipe_smem(D, plan.stages)
    assert (plan.stages == fm.STAGES_MAX
            or mv._pipe_smem(D, plan.stages + 1) > SMEM)
    assert plan.acc_regs == D // 2 + mv.PIPE_FC1_REGS <= mv.PIPE_ACC_BUDGET
    assert plan.stages >= D // 64
    # the weight bytes a row: one 128-row tile streams what one of K2's
    # 64-row tiles streams
    assert (D // 128 + D // 128) * (4 * D // mv.PIPE_HC) * fm.STAGE == (
        2 * D * 4 * D * 2)


@pytest.mark.parametrize("D", [128, 384, 512])
@pytest.mark.parametrize("tm", [32, 64, 128, 256])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_check_pipe_takes_the_set_and_refuses_the_rest(D, tm, splits):
    ok = (tm, splits) in mv.PIPE_SET and (tm == 64 or D <= 384)
    if ok:
        mv.check_pipe(D, tm, splits)
        return
    with pytest.raises(ValueError, match="mlp_pipe"):
        mv.check_pipe(D, tm, splits)


def test_the_tool_sweeps_the_set_default_first():
    """bench_pipelined's sweep is PIPE_SET with the default (ping-pong at
    tm=128) first, and its combined chain takes the default."""
    assert bench_pipelined.PIPE_SWEEP[0] == (2, mv.PIPE_ROWS)
    assert sorted((tm, s) for s, tm in bench_pipelined.PIPE_SWEEP) == sorted(
        mv.PIPE_SET)
    names = [n for n, _, _ in bench_pipelined.chains()]
    assert "attn_staged cb=2 + mlp_pipe s=2" in names


def test_the_former_t3_keeps_its_argument_set():
    """mlp_pipe_mma takes the first design's (tm, splits)."""
    mv.check_pipe_mma(384, 64, 2)
    mv.check_pipe_mma(512, 32, 2)
    for tm, splits, D in ((128, 2, 384), (64, 2, 512), (64, 3, 384),
                          (32, 4, 384)):
        with pytest.raises(ValueError, match="mlp_pipe_mma"):
            mv.check_pipe_mma(D, tm, splits)
    assert "MFV_PIPE(64, 4)" in _FORMER_MLP


def _t3_ring_model(stages: int, D: int, chunks: int, tiles: int,
                   seed: int) -> int:
    """One block of T3's PIPE 2: a producer filling a ring of ``stages``
    (a stage reused once both warpgroups have handed it back), two
    warpgroups taking the same stages in turns, warpgroup 0 first. Turn A
    of chunk c takes fc2 of chunk c - 1 (each stage handed back once read)
    and fc1 of chunk c (its W1 stages kept for the second half); turn B
    runs that half and hands the W1 stages back; a last turn A takes fc2 of
    the last chunk. Returns the stages both warpgroups handed back."""
    n1 = n2 = D // 128
    turns, x = [], 0
    for _ in range(tiles):
        for c in range(chunks + 1):
            a = [(x + i, True) for i in range(n2 if c else 0)]
            x += len(a)
            if c < chunks:
                w1 = list(range(x, x + n1))
                x += n1
                turns.append(a + [(s, False) for s in w1])
                turns.append([(s, None) for s in w1])
            else:
                turns.append(a)
    seq = x
    filled, back = [0], [[0] * seq, [0] * seq]
    done = [0, 0]  # turns each warpgroup has ended

    def producer():
        x = filled[0]
        if x >= seq or (x >= stages and not (back[0][x - stages]
                                              and back[1][x - stages])):
            return False
        filled[0] += 1
        return True

    def wg(w):
        state = {"op": 0}

        def act():
            t = done[w]
            if t >= len(turns):
                return False
            # its turn: the other warpgroup has ended turn t - 1 (w = 0) or
            # t (w = 1)
            if done[1 - w] < t + w:
                return False
            ops = turns[t]
            if state["op"] < len(ops):
                s, now = ops[state["op"]]
                if now is not None and filled[0] <= s:
                    return False
                if now is not False:  # read and handed back
                    back[w][s] = 1
                state["op"] += 1
                return True
            state["op"] = 0
            done[w] += 1
            return True
        return act

    _run([producer, wg(0), wg(1)], random.Random(seed),
         lambda: done == [len(turns)] * 2)
    return sum(back[0]) + sum(back[1])


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


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("D", [128, 256, 384])
def test_the_t3_ring_runs_every_stage_for_both_warpgroups(D, seed):
    """PIPE 2 at the plan's ring: both warpgroups read every stage once
    and the ping-pong never stalls."""
    stages = mv.pipe_plan(D, 4 * D).stages
    chunks = 4 * D // mv.PIPE_HC
    n = _t3_ring_model(stages, D, chunks, 2, seed)
    assert n == 2 * 2 * (2 * (D // 128)) * chunks


def test_the_t3_ring_stalls_below_a_phase():
    """The C side's check: with fewer stages than a turn's D / 64 the
    leading warpgroup waits for a stage that only the other one frees."""
    with pytest.raises(AssertionError, match="stalled"):
        _t3_ring_model(384 // 64 - 1, 384, 4, 1, 0)
    _t3_ring_model(384 // 64, 384, 4, 1, 0)


def test_staged_fwd_constants_are_the_c_source():
    """StagedCore's warps a group by head_dim, its passes, its slot layout
    (T2's), the takers bound and the key-tile counts."""
    g = int(re.search(r"static constexpr int G = (\d+);", _STAGED).group(1))
    assert av.STAGED_FWD_GROUP == {32: g, 64: g, 128: g}
    passes = int(re.search(r"static constexpr int PASSES = (\d+);",
                           _STAGED).group(1))
    assert av.STAGED_FWD_PASSES == {32: passes, 64: passes, 128: passes}
    assert f"constexpr int SMEM_MAX = {av.SMEM_MAX};" in _STAGED
    assert "QS = 2 * 3 * PART * 2 + 4 * 8 <= SMEM_MAX;" in _STAGED
    assert "PARTS = QS ? 3 : 2;" in _STAGED
    assert "SMEM = 2 * SLOT_BYTES + 4 * 8;" in _STAGED
    assert "const int Gt = G < (T + 1) / 2 ? G : (T + 1) / 2;" in _STAGED
    assert "THREADS = (2 * G + 1) * 32;" in _STAGED
    assert "const int k = r * 2 * Gt + grp * Gt + j;" in _STAGED
    keys = [8 * int(n) for n in re.findall(r"return launch<DH, (\d+)>",
                                           _STAGED)]
    assert tuple(keys) == av.KEYS


def test_t4s_walk_is_the_c_walk():
    """T4's blocks find a block's i-th image as ``unit_walk`` does."""
    assert "(size_t)((bid + i / cb * grid) / heads * cb + i % cb)" in _STAGED
    assert "(bid + i / cb * grid) % heads * DH" in _STAGED
    assert "const int units = B / cb * heads" in _STAGED
    assert "units < sms ? units : sms" in _STAGED


@pytest.mark.parametrize("B,H,cb,grid", [(8, 12, 2, 7), (8, 12, 4, 132),
                                         (256, 12, 2, 132),
                                         (256, 12, 4, 132), (6, 3, 2, 9),
                                         (3, 12, 1, 36)])
def test_unit_walk_covers_every_pair_once_at_t4s_cb(B, H, cb, grid):
    walk = av.unit_walk(B, H, cb, grid)
    pairs = [p for blk in walk for p in blk]
    assert sorted(pairs) == [(b, h) for b in range(B) for h in range(H)]
    assert all(len(blk) % cb == 0 for blk in walk)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("N", [50, 197, 208])
def test_the_staged_fwd_ring_fits_a_block(dh, N):
    """T4's two slots (q, K and V; K and V at head_dim 128 past 128 keys)
    fit 232,448 bytes, and at most (T + 1) // 2 warps a group take tiles."""
    plan = av.staged_fwd_plan(N, dh)
    part = plan.keys * (dh + 8) * 2
    assert plan.slot_bytes == (3 if plan.q_staged else 2) * part
    assert plan.smem == 2 * plan.slot_bytes + 32 <= SMEM
    assert plan.q_staged or (dh == 128 and plan.keys == 208)
    T = -(-N // 16)
    assert plan.takers == min(av.STAGED_FWD_GROUP[dh], (T + 1) // 2)
    assert 2 * plan.takers <= T + 1
    assert plan.group == av.STAGED_FWD_GROUP[dh]
    # the block's threads: two groups and the producer warp, and the
    # registers that leaves a thread (136 at 7 warps a group)
    assert 65536 // ((2 * plan.group + 1) * 32) >= 128


def test_the_staged_fwd_plan_refuses_head_dim_128_past_208():
    with pytest.raises(ValueError, match="N"):
        av.staged_fwd_plan(209, 128)
    assert av.staged_fwd_plan(256, 64).keys == 256


def _staged_fwd_model(images: int, T: int, Gt: int, seed: int) -> list:
    """One block of T4's core: a producer filling a ring of two slots
    (image i after image i - 2 was handed back), two groups of Gt warps
    taking turns (a group's turn opens once all its warps wait and the
    other group has passed its last turn; group 0 first), each warp in its
    turn running its deferred tile's P V (which hands a tile of the slot
    back), then waiting for its next tile's image and running its scores,
    then passing the turn and deferring that tile. Returns the P V count of
    each tile."""
    total = images * T
    rounds = -(-total // (2 * Gt))
    filled, released = [0], [0] * images
    pv = [0] * total
    arrived = [[0] * Gt for _ in range(2)]  # turn waits reached
    passes = [[0] * Gt, [1] * Gt]  # turns passed (group 1's first pass)

    def producer():
        i = filled[0]
        if i >= images or (i >= 2 and released[i - 2] < T):
            return False
        filled[0] += 1
        return True

    def warp(grp, j):
        st = {"r": 0, "stage": "wait", "deferred": None, "cur": None}

        def act():
            r = st["r"]
            if r > rounds:
                return False
            if st["stage"] == "wait":
                arrived[grp][j] += 1
                st["stage"] = "blocked"
                return True
            if st["stage"] == "blocked":
                if (min(arrived[grp]) < r + 1
                        or min(passes[1 - grp]) < r + 1):
                    return False
                d = st["deferred"]
                if d is not None:  # its P V, the slot's tile handed back
                    pv[d] += 1
                    released[d // T] += 1
                    st["deferred"] = None
                st["stage"] = "scores"
                return True
            if st["stage"] == "scores":
                k = r * 2 * Gt + grp * Gt + j
                if r < rounds and k < total:
                    i = k // T
                    if filled[0] <= i:
                        # parity alone: image i - 2's fill has landed
                        assert filled[0] >= i - 1, "a wait two rounds ahead"
                        return False
                    st["cur"] = k
                if not (grp == 1 and r == rounds):
                    passes[grp][j] += 1
                st["stage"] = "softmax"
                return True
            st["deferred"], st["cur"] = st["cur"], None  # its softmax
            st["r"] += 1
            st["stage"] = "wait"
            return True
        return act

    actors = [producer] + [warp(g, j) for g in range(2) for j in range(Gt)]
    _run(actors, random.Random(seed),
         lambda: all(r == T for r in released))
    return pv


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("N,dh,images", [(197, 32, 8), (50, 32, 9),
                                         (208, 128, 6), (197, 64, 16),
                                         (16, 32, 5), (100, 128, 7)])
def test_the_staged_fwd_ring_runs_every_tile_once(N, dh, images, seed):
    """T4's protocol at the plan's takers: every tile's P V runs once, a
    warp waits only one round ahead of its slot's last fill, and nothing
    stalls."""
    T = -(-N // 16)
    pv = _staged_fwd_model(images, T, av.staged_fwd_plan(N, dh).takers,
                           seed)
    assert pv == [1] * (images * T)


def test_the_staged_fwd_model_fails_past_its_bound():
    """2 Gt <= T + 1 is what keeps the turns moving: with T = 4 tiles an
    image and 3 takers a group, a warp waits, inside its turn, for an image
    whose slot a deferred tile of the other group still holds (or waits two
    rounds ahead)."""
    with pytest.raises(AssertionError, match="stalled|two rounds"):
        for seed in range(20):
            _staged_fwd_model(8, 4, 3, seed)


def _c_args(name: str, text: str) -> str:
    """The kinds of a C entry point's parameters: P pointer, I int, F
    float."""
    m = re.search(r"MFV_API int %s\((.*?)\)\s*\{" % name, text, re.S)
    args = [a.strip() for a in m.group(1).split(",")]
    return "".join("P" if "*" in a else "F" if a.startswith("float")
                   else "I" for a in args)


@pytest.mark.parametrize("name,text", [
    ("mfv_mlp_pipe", _PIPE), ("mfv_mlp_pipe_mma", _FORMER_MLP),
    ("mfv_attn_staged", _STAGED), ("mfv_attn_staged_wmma", _STAGED_WMMA)])
def test_the_new_and_former_entries_argtypes_match_their_signatures(name,
                                                                    text):
    kinds = {build._P: "P", build._I: "I", build._F: "F"}
    assert "".join(kinds[t] for t in build.SIGNATURES[name]) == _c_args(
        name, text)


def test_t4_drops_the_statistics_scratch_and_t3_takes_its_ring():
    """T4 on K1's chain takes no LN statistics (its former design does);
    T3 takes the ring's stages that ``pipe_plan`` sizes."""
    assert len(build.SIGNATURES["mfv_attn_staged_wmma"]) == len(
        build.SIGNATURES["mfv_attn_staged"]) + 1
    assert "stats" not in _STAGED.split("MFV_API int mfv_attn_staged(")[1]
    assert "int stages" in _PIPE.split("MFV_API int mfv_mlp_pipe(")[1]


@pytest.mark.parametrize("tag", sorted(core_trials.FWD_TRIALS))
def test_core_trials_fwd_trees_set_the_constants(tmp_path, tag):
    """``tools/core_trials.py --set t3t4``'s copies: only the sources K1,
    K2, T3 and T4 build from, T4's warps and passes and T3's setmaxnreg
    pair as the trial says; the "tree" trial is this checkout's setting,
    so its copy leaves the sources as they are."""
    core_trials.make_fwd_tree(build.CSRC.parents[1], tmp_path,
                              core_trials.FWD_TRIALS[tag])
    csrc = tmp_path / "mfvit_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == core_trials.FWD_SOURCES
    (g, g128), (passes, passes128), (regs, pregs) = core_trials.FWD_TRIALS[
        tag]
    assert 2 * 128 * regs + 128 * pregs <= 65536
    staged = (csrc / "attn_staged.cu").read_text()
    tail = (csrc / "block_tail.cuh").read_text()
    assert f"int G = DH == 128 ? {g128} : {g};" in staged
    assert f"int PASSES = DH == 128 ? {passes128} : {passes};" in staged
    assert (f"PIPE_CONSUMER_REGS = {regs}, PIPE_PRODUCER_REGS = {pregs};"
            in tail)
    if tag == "tree":
        assert (g, g128) == (av.STAGED_FWD_GROUP[32],
                             av.STAGED_FWD_GROUP[128])
        assert (passes, passes128) == (av.STAGED_FWD_PASSES[32],
                                       av.STAGED_FWD_PASSES[128])
        assert (regs, pregs) == (mv.PIPE_CONSUMER_REGS,
                                 mv.PIPE_PRODUCER_REGS)
        assert tail == _TAIL
