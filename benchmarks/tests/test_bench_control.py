"""The control on the card at the tiny sizes: on three seeds the
program comes out correct by the cells' committed limits, and the
reference computed at TF32, the precision below the configurations'
float32, in the program's place comes out not correct, or (where the
tiny sizes move it less than the full ones, whose readings set the
limits: ``python3 -m benchmarks.calibrate`` on the card) reads ten
times the program on one of the numbers compared."""

import pytest

from benchmarks import calibrate, cells, run
from benchmarks.yardstick import compare

WORKLOADS = ["neus-blender.train",
             "split-mixed-occ-tensoir.render",
             "split-mixed-occ-tensoir.train-s1-det"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny_root, card, workload):
    cell = cells.load(workload, root=tiny_root, here=tiny_root / "benchmarks")
    run._environment(cell.traffic)
    readings = {"train": calibrate.TrainReadings,
                "render": calibrate.RenderReadings}[cell.traffic["kind"]](
                    cell, 11, card)
    for seed in (11, 12_000_000_013, 4_100_000_017):
        out = readings(seed, True, False)
        prog, ctrl = out["program"], out["control"]
        assert compare.judge(prog, cell.limits), out
        assert not compare.judge(ctrl, cell.limits) or any(
            ctrl[k] > 10 * prog[k] + 1e-12 for k in cell.limits), out
