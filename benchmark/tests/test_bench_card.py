"""On the card, at each cell's own size and on three seeds: the program's
runs pass the limits, and the control (the reference computed in float8
in the program's place) and every fault of the cell fail one of them,
judged as a run judges the program. Run on a machine with the card:

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -s
"""

import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
import calibrate
from harness import check, manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
SEEDS = (3_141_592_653, 2_718_281_828, 1_618_033_988)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own sizes on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_faults_and_control_against_the_limits(card, workload):
    cell = manifest.Cell(manifest.load_manifest(), workload)
    fn = calibrate.train_readings if cell.kind == "train" else calibrate.view_readings
    for seed in SEEDS:
        sound = calibrate.sound(cell, seed, card)
        assert check.judge(sound, cell.limits)[0], (seed, sound)
        for name, numbers in fn(cell, seed, card).items():
            caught = not check.judge(numbers, cell.limits)[0]
            print(workload, seed, name, "caught" if caught else "passes", numbers)
            assert caught, (seed, name, numbers)
