"""Summarize a torch.profiler Chrome trace from the command line.

Counterpart of `pixelnerf_tpu/tools/xprof_summary.py`, which reads a TPU
XPlane: this reads the Chrome trace that `tools/profile_step.py` writes
(`<out>/trace.json`) and sums the device time of its CUDA kernels, copies
and sets (the events of categories `kernel`, `gpu_memcpy` and
`gpu_memset`) by name, then into buckets of the port's own kernels (first
matching pattern wins): the fused field, the block chains, the layered
path, the weight-gradient products, the lookups, posenc, the encoder's
cuDNN convolutions, elementwise work. A trace with no device events (a
CPU run) is summarized over its host operators (`cpu_op`) instead, and
says so.

Usage:
    python -m pixelnerf_tpu_torch.tools.profile_step -c conf/exp/srn.conf --out /tmp/prof
    python -m pixelnerf_tpu_torch.tools.trace_summary --logdir /tmp/prof --top 15 --steps 3

or, from Python, `main(argv)`, which returns (device, total ms, {bucket:
ms}, {name: ms}).
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# unit buckets: first matching pattern wins (order matters); the field's
# backward is the chain kernel compiled with its level scatter (FIELD true)
DEFAULT_BUCKETS = (
    ("fused field kernels", r"field_fwd_kernel|resnetfc_bwd_chain_kernel<\d+, *true>"),
    ("block chains", r"resnetfc_fwd_kernel|resnetfc_bwd_chain_kernel"),
    ("layered path", r"layer_fwd_kernel|layer_bwd_kernel|view_pool_(fwd|bwd)_kernel"),
    ("weight-gradient products", r"wgrad_products|wgrad_reduce"),
    ("lookup kernels", r"pyramid_(gather|scatter)_kernel|bilerp_(gather|scatter)_kernel"),
    ("posenc kernel", r"posenc_kernel"),
    ("cuDNN convolutions", r"conv|cudnn|winograd|implicit_gemm|wgrad_alg|dgrad|fprop|nchw|nhwc"),
    ("matmul (cuBLAS)", r"gemm|cutlass|xmma"),
    ("sort", r"sort|radix"),
    ("host/device transfers", r"memcpy|memset"),
    ("elementwise (sampling, compositing, Adam)", r"elementwise|vectorized|reduce|index|scatter|"
     r"gather|copy|fill|cat|softmax|cumsum|batch_norm|foreach|unrolled|distribution"),
)


def load_trace(logdir: str) -> dict:
    """The trace at `logdir/trace.json` (or `logdir` itself, a file)."""
    path = logdir if os.path.isfile(logdir) else os.path.join(logdir, "trace.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace.json under {logdir}")
    with open(path) as f:
        return json.load(f)


def summarize(trace: dict):
    """-> (device, total_ms, {name: ms}): device is "cuda" when the trace
    holds device events (their time summed), else "cpu" (host operators)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    picked, where = (device, "cuda") if device else ([e for e in events if e.get("cat") == "cpu_op"], "cpu")
    per_op: dict = defaultdict(float)
    for e in picked:
        per_op[e.get("name", "?")] += float(e["dur"]) / 1e3  # microseconds
    return where, sum(per_op.values()), dict(per_op)


def bucketize(per_op, buckets=DEFAULT_BUCKETS):
    out = defaultdict(float)
    for name, ms in per_op.items():
        for label, pat in buckets:
            if re.search(pat, name, re.IGNORECASE):
                out[label] += ms
                break
        else:
            out["other"] += ms
    return dict(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--logdir", required=True, help="profile_step's --out, or a trace file")
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument(
        "--steps", type=int, default=0,
        help="if set, also print per-step averages (trace captured N steps)",
    )
    args = parser.parse_args(argv)

    where, total_ms, per_op = summarize(load_trace(args.logdir))
    buckets = bucketize(per_op)
    what = "device time of CUDA kernels and copies" if where == "cuda" else (
        "host operator time (no device events: a CPU trace)")
    print(f"== {args.logdir}: {total_ms:.3f} ms {what} ==")
    den = args.steps or 1
    unit = "ms/step" if args.steps else "ms"
    if args.steps:
        print(f"   per step ({args.steps}): {total_ms / args.steps:.3f} ms")
    print(f"-- buckets ({unit}, % of the total) --")
    for label, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        print(f"{ms / den:10.3f} {unit}  {100 * ms / max(total_ms, 1e-30):5.1f}%  {label}")
    print(f"-- top {args.top} ({unit}) --")
    for name, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{ms / den:10.3f} {unit}  {name[:100]}")
    return where, total_ms, buckets, per_op


if __name__ == "__main__":
    main()
