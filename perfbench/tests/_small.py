"""A checkout-shaped copy of the benchmark at a size a CPU test holds:
the same files, with the configurations' rows and the traffic's fleets
cut down.  The limits stay the committed ones."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL_ROWS = {"n_samples": 4096, "n_features": 256, "density": 0.02,
              "instance_seed": 0}


def small_root(tmp: Path, workers: int = 4, rounds: int = 4) -> Path:
    tmp = Path(tmp)
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["rows"] = dict(SMALL_ROWS)
        if "sketch" in cfg:
            cfg["sketch"]["sketch_dim"] = 8 * SMALL_ROWS["n_features"]
        path.write_text(json.dumps(cfg))
    for path in (tmp / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["workers"], t["rounds_per_solve"] = workers, rounds
        path.write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, workload: str, seed: int = 2 ** 31 + 11, *,
        trace: bool = False, control: bool = False, max_solves: int = 2,
        seconds: float = float("inf")):
    import time
    from perfbench.harness import bench, spec
    cell = spec.cell_spec(workload, root=root)
    return bench.run_cell(cell, seed, seconds, trace, "cpu",
                          time.perf_counter(), max_solves=max_solves,
                          control=control)


def numbers(out) -> dict:
    return {c.name: c.value for c in out["checks"]}
