"""A cell added from new files alone: a configuration, a traffic mix with its
driver, a per-layer metric and the cell's limits, with entries appended to
BENCHMARK.json, and no existing file edited."""
import filecmp
import json
import shutil
import subprocess
import sys
import textwrap

from portbench import run

ROOT = run.ROOT

TOY_DRIVER = textwrap.dedent('''
    import torch


    class Driver:
        def __init__(self, root, config, mix, seed, device="cpu"):
            self.n = int(mix["n"]) * int(config["width"])
            self.g = torch.Generator().manual_seed(seed)

        def setup(self):
            self.a = torch.randn(self.n, self.n, generator=self.g)

        def work(self):
            return self.a @ self.a

        def step(self):
            self.work()
            return 1

        def counters(self):
            return {}

        def layer_callables(self):
            return [(self, "work", "network")]

        def end_to_end(self, window):
            return {"toy_per_s": {"value": window.rate(), "unit": "steps/s"}}

        def failed(self, n):
            return 0

        def flops_per_step(self, per_step):
            return 2.0 * self.n ** 3

        def release(self):
            self.a = None

        def check(self, n_window, control=False):
            return {"toy_gap": 0.0}
''')

TOY_METRIC = textwrap.dedent('''
    def read(ctx):
        return ctx.per_step["network_s"] * 1e3
''')


def make_tree(tmp_path):
    """A copy of the benchmark with the toy cell's files and entries added."""
    root = tmp_path / "tree"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test", "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.tiny", "config": "toy", "traffic": "tiny",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "toy_per_s", "unit": "steps/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["toy.tiny"]})
    bench["per_layer"].append({"name": "toy_ms.toy", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "Toy", "moves": "toy_per_s",
                               "workloads": ["toy.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "portbench"
    (b / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "width": 8}))
    (b / "traffic" / "tiny.json").write_text(json.dumps({"kind": "toy", "n": 4}))
    (b / "traffic" / "toy.py").write_text(TOY_DRIVER)
    (b / "metrics" / "toy_ms.toy.py").write_text(TOY_METRIC)
    (b / "limits" / "toy.tiny.json").write_text(json.dumps({"limits": {"toy_gap": 0.0}}))
    return root


def test_a_cell_from_new_files_alone(tmp_path):
    root = make_tree(tmp_path)
    # every file the repo's benchmark has is there, unedited
    cmp = filecmp.dircmp(ROOT / "portbench", root / "portbench",
                         ignore=["__pycache__", "tests"])

    def same(c):
        return not c.diff_files and all(same(s) for s in c.subdirs.values())
    assert same(cmp) and not cmp.left_only
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert new[key][: len(old[key])] == old[key]

    e2e = json.loads(run.run_cell("toy.tiny", 5, 0.3, 0, "cpu", root=root))
    assert e2e["correct"] and set(e2e["metrics"]) == {"setup_s", "toy_per_s"}
    traced = json.loads(run.run_cell("toy.tiny", 5, 0.3, 1, "cpu", root=root))
    assert set(traced["metrics"]) == {"toy_ms.toy"} and traced["metrics"]["toy_ms.toy"]["value"] > 0


def test_no_module_the_harness_runs_imports_jax():
    """Every module the harness runs, imported in a fresh process: no top-level
    module name (the part before the first dot, whole) is jax's or the JAX
    package's, and the port's own name passes."""
    code = textwrap.dedent(f'''
        import sys, pathlib
        sys.path.insert(0, {str(ROOT)!r})
        from portbench import run, harness, tracing, flops, ref_check, calibrate, series, lane_sweep, faults
        from portbench.ref import envs, policies
        from portbench.ref.utils import checkpoint
        b = pathlib.Path({str(ROOT)!r}) / "portbench"
        for kind in sorted((b / "traffic").glob("*.py")):
            run.load_module(kind, "k_" + kind.stem)
        for m in sorted((b / "metrics").glob("*.py")):
            run.load_module(m, "m_" + m.stem.replace(".", "_"))
        import deqmpc_tpu_torch.envs, deqmpc_tpu_torch.policies, deqmpc_tpu_torch.utils.checkpoint
        import deqmpc_tpu_torch.solvers.newton_al, deqmpc_tpu_torch.ops.block_tridiag
        assert "deqmpc_tpu_torch" in sys.modules
        print(harness.forbidden_loaded())
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
