"""The reference against the port at a tiny size on the CPU, and `correct`
coming out false for each fault a cell can have (`portbench/faults.py`),
planted in the port under the whole of a run (the harness's look for a card
skipped). The rexquad cell, kept out of BENCHMARK.json for its spread on the
card (PERF.md), keeps its configuration and limits; it runs here from a tree
whose BENCHMARK.json holds its entries, as a later PR would add them."""
import json

import pytest
import torch

from portbench import faults, run

SEED = 2**31 + 99
TINY = {"lanes": 4}
SECONDS = 20.0  # at least one whole tick on the CPU, also on a loaded host
REXQUAD = "rexquad_deqmpc.fleet4096"
WORKLOADS = [REXQUAD, "flying_deqmpc_nn.fleet4096"]
REXQUAD_CONFIG = {
    "name": "rexquad_deqmpc",
    "source": "Gurumurthy et al., Deep Equilibrium Model Predictive Control (CoRL 2024); "
              "config #4 of configs/run.sh:31-33",
    "file": "portbench/configs/rexquad_deqmpc.json", "reduced": [],
    "why": "RexQuadrotor n 16, T 5, deq-mpc-deq gcn trunk hdim 256"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tree of the benchmark whose BENCHMARK.json also holds the rexquad cell."""
    tree = tmp_path_factory.mktemp("tree")
    for name in ("portbench", "checkpoints"):
        (tree / name).symlink_to(run.ROOT / name)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    if REXQUAD not in {w["name"] for w in bench["workloads"]}:
        bench["configs"].append(REXQUAD_CONFIG)
        bench["workloads"].append({"name": REXQUAD, "config": "rexquad_deqmpc",
                                   "traffic": "fleet4096", "chips": 1, "why": "the tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(REXQUAD)
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return tree


def run_tiny(root, workload, trace=0):
    torch.set_num_threads(4)
    return json.loads(run.run_cell(workload, SEED, SECONDS, trace, "cpu", mix_update=TINY,
                                   root=root))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_port_on_the_cpu(root, workload):
    d = run_tiny(root, workload)
    assert d["correct"], d["checks"]
    assert all(c["value"] == 0.0 for c in d["checks"].values()), d["checks"]
    assert d["attempted"] > 0 and d["failed"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(root, workload, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch)
    d = run_tiny(root, workload)
    assert not d["correct"], d["checks"]
