"""Run one cell traced, as `run.py --trace 1` runs it, and print what the
program's `pnt.*` spans show of the traced window beside the result.

    python3 benchmark/span_readings.py --workload srn.train --seed 1234 --seconds 40

from the root of a checkout, on the card. `run.py` does not read the
spans; this reads them from the same profiler run (`harness/spans.py`)
and prints, as one JSON line last on standard output: the result's
per-layer metrics and `correct`, the span readings by metric name
(`spans.readings`), the share of the device time launched in each
`bench.*` span that is put down to a `pnt.*` span, device and idle ms a
step or view by innermost span, how often each span opened, the host ms
of a traced step or view, each span's longest operations, the MLP
kernels' device ms a step beside the three MLP spans', and the chunk
counters of `render_full`. Device and idle ms put down to a span through
an autograd node's forward link are keyed `<span> (backward)`. Against a
program without spans every span reading is null.
"""

import argparse
import json
import sys
from collections import defaultdict

import run
from harness import family, manifest, spans, train_cell, view_cell
from harness.trace import MLP_BUCKETS, read_profile


def _per_unit(d, units):
    return {str(k): 1e3 * v / units for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def _top_ops(sp, units, n=3):
    """{span: {op name: device ms a unit}} of each span's `n` longest."""
    per = defaultdict(lambda: defaultdict(float))
    for o in sp.ops:
        per[str(o.span)][o.name[:90]] += 1e3 * o.seconds / units
    return {span: dict(sorted(ops.items(), key=lambda kv: -kv[1])[:n]) for span, ops in per.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.Cell(manifest.load_manifest(run.ROOT), args.workload)
    print(json.dumps(measure(cell, args.seed, args.seconds, args.device)))
    return 0


def measure(cell, seed: int, seconds: float, device) -> dict:
    """Run `cell` traced and read its spans (the printed line's object)."""
    seen = {}

    def read(prof, **kw):
        seen["spans"] = spans.read_spans(prof)
        seen["trace"] = read_profile(prof, **kw)
        return seen["trace"]

    for mod in (train_cell, view_cell):
        mod.read_profile = read
    try:
        result = run.run_cell(cell, seed, seconds, True, device)
    finally:
        for mod in (train_cell, view_cell):
            mod.read_profile = read_profile

    data, traffic = cell.config["data"], cell.traffic
    if cell.kind == "train":
        units, benches = int(traffic["trace_steps"]), ("bench.step",)
        parts = family.load(cell.family).train_parts(cell.config, traffic)
    else:
        h, w = data["image_hw"]
        units, benches, parts = -(-int(traffic["trace_rays"]) // (h * w)), ("bench.encode",
                                                                        "bench.render"), None
    sp, trace = seen["spans"], seen["trace"]
    out = {
        "workload": cell.name, "seed": seed, "correct": result["correct"], "check": result["check"],
        "device": result["device"], "metrics": result["metrics"], "units": units,
        "spans": spans.readings(sp, cell.kind, units, parts),
        "coverage": {b: sp.coverage(b) for b in benches},
        "host_ms_per_unit": 1e3 * trace.window_s / units,
        "device_ms_by_span": _per_unit(sp.by_span(linked=True), units),
        "idle_ms_by_span": _per_unit(sp.idle_by_span(linked=True), units),
        "top_ops_by_span": _top_ops(sp, units),
        "opened": sp.opened,
    }
    if cell.kind == "train":
        out["mlp_ms"] = {
            "kernels": 1e3 * trace.seconds(MLP_BUCKETS) / units,
            "spans": 1e3 * (sp.seconds("pnt.mlp.fwd") + sp.seconds("pnt.mlp.bwd")) / units,
            "fwd": 1e3 * sp.seconds("pnt.mlp.fwd") / units,
            "chain": 1e3 * sp.seconds("pnt.mlp.bwd", exclude=spans.WGRAD) / units,
            "wgrad": 1e3 * sp.seconds("pnt.mlp.bwd", buckets=spans.WGRAD) / units,
        }
    else:
        from pixelnerf_tpu_torch.eval.render_utils import render_full

        out["render_full"] = {k: getattr(render_full, k, None) for k in ("rays", "padded_rays")}
    return out


if __name__ == "__main__":
    sys.exit(main())
