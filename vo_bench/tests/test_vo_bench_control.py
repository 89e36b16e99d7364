"""The control on the card, at each cell's own size: the plain reference
in bfloat16, in the program's place, fails one of the cell's numbers on
three seeds, while the program on the same frames passes every one.
`vo_bench/calibrate.py --control` gives the readings the limits were set
from; this keeps the separation as a test. Runs on the card only:

    python3 -m pytest vo_bench/tests -m gpu
"""

import pytest
import torch

from vo_bench.harness import check as CHECK
from vo_bench.harness import frames as FR
from vo_bench.harness import spec as SPEC

CELLS = [w["name"] for w in SPEC.benchmark()["workloads"]
         if SPEC.load_json(SPEC.BENCH_DIR / "workloads" / f"{w['name']}.json")[
             "entry"] == "frame"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    c = SPEC.load_cell(cell)
    limits = c.workload["check"]
    for seed in (17, 2 ** 31 + 3, 424242):
        fc = FR.FrameCell(c, seed, card)
        fc.warm_up()
        _, _, failed = fc.window(4.0)
        solves = list(fc.ba_solves) if fc.pipe.wba is not None else None
        scene, index = fc.scene, fc.scene_index
        fc.free()
        pq = c.workload["pose_quantile"]
        prog = CHECK.frame_numbers(scene, fc.records, solves, index, card,
                                   pq)
        ctrl = CHECK.frame_numbers(scene, fc.records, solves, index, card,
                                   pq, torch.bfloat16)
        assert CHECK.judge(prog, limits, failed)[0], (seed, prog)
        assert not CHECK.judge(ctrl, limits, 0)[0], (seed, ctrl)
