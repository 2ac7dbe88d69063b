"""T6 (``mlp3d``) and T7 (``mlp3d_staged``) on K2's tail, on the CPU: the
row walk the wrappers hand the kernel (``mlp_variants.row_walk``, the
Python twin of csrc/block_tail.cuh's RUNS walk) and T7's launch plan
(``mlp_variants._plan``). Their kernels run only on the card
(``tests/test_torch_port_cuda.py``: equal to K2 and to their former
designs bit for bit); their plain versions are held against the JAX tool
in ``tests/test_torch_port_variants.py``."""
from __future__ import annotations

import re

import pytest

from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.ops import fused_mlp as fm
from mfvit_tpu_torch.ops import mlp_variants as mv

_TAIL = (build.CSRC / "block_tail.cuh").read_text()

# (B, N, cb) with cb dividing B: the smoke's ragged B=3, a small batch and
# the timed B=256, at the tools' N and at N=50
WALKS = [(B, N, cb) for B in (3, 8, 256) for N in (50, 197)
         for cb in (1, 2, 4, 8) if B % cb == 0]


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("B,N,cb", WALKS)
def test_row_walk_covers_every_row_once_within_its_run(B, N, cb, flat):
    """Every row of the B * N is stored by exactly one tile; no tile stores
    rows of two groups of cb images (flat) or of two images (per image);
    each tile stores at most 64 rows and starts on its run's 64-row grid;
    the tile count is each run's ceil(run / 64) times the runs."""
    walk = mv.row_walk(B, N, cb, flat)
    run = cb * N if flat else N
    assert walk.run == run and walk.per_run == -(-run // 64)
    assert walk.tiles == (B * N // run) * -(-run // 64)
    seen = [0] * (B * N)
    for t in range(walk.tiles):
        first, rows = mv.tile_rows(walk, t)
        assert 1 <= rows <= fm.TAIL_ROWS
        assert (first % run) % fm.TAIL_ROWS == 0
        assert first // run == (first + rows - 1) // run  # one run
        for r in range(first, first + rows):
            seen[r] += 1
    assert seen == [1] * (B * N)


@pytest.mark.parametrize("cb,flat,tiles", [(2, True, 896), (4, True, 832),
                                           (8, True, 800), (2, False, 1024),
                                           (4, False, 1024),
                                           (8, False, 1024)])
def test_row_walk_tile_counts_at_vit_small_b256(cb, flat, tiles):
    """At vit_small B=256 (N=197): T6 flat 896 / 832 / 800 tiles at cb 2 /
    4 / 8 (one ragged tile a run), per image and T7 1,024 (four a 197-row
    image, the last of 5 rows), against K2's 788."""
    walk = mv.row_walk(256, 197, cb, flat)
    assert walk.tiles == tiles
    assert -(-256 * 197 // fm.TAIL_ROWS) == 788
    if not flat:
        assert mv.tile_rows(walk, 3) == (192, 5)


def test_row_walk_is_the_c_walk():
    """block_tail.cuh's tile start and stored rows are the formulas
    ``tile_rows`` mirrors, its launch derives per_run from run as
    ``row_walk`` does and checks the tile count the wrapper passes."""
    assert ("(t / p.per_run) * p.run + (t % p.per_run) * TAIL_ROWS"
            in _TAIL)
    assert "min(TAIL_ROWS, p.run - (t % p.per_run) * TAIL_ROWS)" in _TAIL
    assert "p.per_run = (p.run + TAIL_ROWS - 1) / TAIL_ROWS;" in _TAIL
    assert "p.tiles != p.M / p.run * p.per_run" in _TAIL


@pytest.mark.parametrize("hidden", [1, 4])
@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_t7_plan_fits_at_every_width(D, hidden):
    """T7's ring beside K2's tiles and its second hidden-chunk buffer: at
    least 2 stages, as many as fit (at most STAGES_MAX), within a block's
    shared memory on an H100; its accumulators (fc2's D/4 and two fc1
    chunks' 32) within the consumer register budget."""
    plan = mv._plan(D, hidden * D)
    assert plan.route == "tail" and plan == mv._plan(D, 4 * D)
    assert 2 <= plan.stages <= fm.STAGES_MAX
    assert plan.smem == fm._smem(D, plan.stages) + 2 * fm.TILE64
    assert plan.smem <= fm.SMEM_MAX
    assert plan.stages == fm.STAGES_MAX or \
        mv._smem(D, plan.stages + 1) > fm.SMEM_MAX
    assert plan.acc_regs == D // 4 + 64 <= mv.ACC_BUDGET < fm.CONSUMER_REGS


@pytest.mark.parametrize("D,stages", [(128, 8), (256, 8), (384, 6), (512, 4)])
def test_t7_gives_up_the_stages_its_second_buffer_costs(D, stages):
    """The second hidden buffer (16 KB, one ring stage) costs T7 a stage
    where K2's ring is not already at STAGES_MAX: 6 at D=384 (K2 7), 4 at
    D=512 (K2 5). T6 runs K2's plan."""
    assert mv._plan(D, 4 * D).stages == stages
    assert fm._plan(D, 4 * D).stages == min(stages + 1, fm.STAGES_MAX)


def test_t7_plan_constants_are_the_c_sources():
    """The C side lays out hb hidden buffers (two under OVERLAP) after the
    A tile, and takes T6 and T7 at the widths the Python side plans."""
    assert "hb * H_BYTES" in _TAIL and "OVERLAP ? 2 : 1" in _TAIL
    widths = set(map(int, re.findall(
        r"case (\d+): return launch_tail<\d+, false, false, true, OVERLAP>",
        _TAIL)))
    assert widths == set(mv.WIDTHS)


@pytest.mark.parametrize("D,Hd", [(768, 3072), (64, 256), (384, 1500),
                                  (384, 0)])
def test_t7_plan_refuses_what_the_kernel_does_not_take(D, Hd):
    with pytest.raises(ValueError, match="mlp3d_staged"):
        mv._plan(D, Hd)
