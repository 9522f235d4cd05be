"""On the card: the control (the reference with TF32 on, in the program's
place) fails one of a cell's limits, and the program passes them all, at
the cell's own size. Skips without a card."""
import json

import pytest
import torch

from portbench import run

SEED = 2**31 + 4242
WORKLOADS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(card, workload):
    _, config, mix, _, _ = run.load_cell(workload)
    limits = json.loads((run.ROOT / "portbench" / "limits" / f"{workload}.json").read_text())
    limits = limits["limits"]
    driver = run.make_driver(config, mix, SEED, "cuda")
    driver.setup()
    ticks = int(mix["compare_ticks"])
    for _ in range(ticks):
        driver.step()
    torch.cuda.synchronize()
    program = driver.check(ticks)
    control = driver.check(ticks, control=True)
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
