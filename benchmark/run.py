"""Run one cell of the port's benchmark on the card.

    python3 benchmark/run.py --workload srn.train --seed 1234 --seconds 40 --trace 0

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name from `BENCHMARK.json`
(`harness/manifest.py`). With `--trace 0` the run measures the cell's
end-to-end metrics over `--seconds`; with `--trace 1` it runs the same
window, then traces a fixed stretch of the same traffic with
`torch.profiler` and reports the per-layer metrics, `busy_s`, `window_s` and a `breakdown`. Either way it
compares what the timed path produced with the plain reference and
prints each compared number beside its limit, last on standard error and
last in the result, which is the last line of standard output.

It fails, printing no result, without as many CUDA devices as the cell
asks for, or when JAX or the JAX package was loaded. The kernels build
into `build/` in the checkout, the only cache the program keeps.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import guard, manifest

    cell = manifest.Cell(manifest.load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _fail(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")

    loaded = guard.loaded_jax_side()
    if loaded:
        _fail(f"the JAX side was loaded in this process: {loaded}")
    print(f"benchmark: {args.workload} seed {args.seed} on {_card_line()}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """Run a cell and assemble the result line's object."""
    import torch

    from harness import family, train_cell, view_cell
    from harness.check import judge
    from harness.manifest import load_reader
    from harness.runrec import Run

    runner = {"train": train_cell, "view": view_cell}[cell.kind]
    got = runner.run(cell, seed, seconds, traced, device, T0)
    ok, table = judge(got["numbers"], cell.limits)
    on_card = torch.device(device).type == "cuda"
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(got["peak_bytes"]),
    }
    metrics, breakdown = {}, None
    if traced:
        work = family.load(cell.family).cell_work(cell.config, cell.traffic)
        run = Run(kind=cell.kind, work=work, units=got["units"], trace=got["trace"],
                  timed_s=got["timed_s"], timed_units=got["timed_units"],
                  encode_ms=got.get("encode_ms", []))
        for m in cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = got["trace"].busy_s
        dev["window_s"] = got["trace"].window_s
        breakdown = {"device_ops": [[n, s] for n, s in got["trace"].top_ops(10)],
                     "idle_gaps": [[n, s] for n, s in got["trace"].gaps]}
    else:
        values = dict(got)
        values["peak_mem_gib"] = got["peak_bytes"] / 2 ** 30
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": bool(ok and got["failed"] == 0),
        "attempted": int(got["attempted"]),
        "failed": int(got["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    print("set-up, seconds from start at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in got["phases"].items()), file=sys.stderr)
    return result


if __name__ == "__main__":
    sys.exit(main())
