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
says so. With device events it also sums them by the innermost `pnt.*`
span of the program (`utils/spans.py`) around their launch: the
launch-to-kernel flow events (`ac2g`) give each kernel's launch, and where
an autograd node encloses the launch before any span does (aten backward
work), the forward-to-backward flow events (`fwdbwd`) give the forward
operation whose span it is put down to.

Usage:
    python -m pixelnerf_tpu_torch.tools.profile_step -c conf/exp/srn.conf --out /tmp/prof
    python -m pixelnerf_tpu_torch.tools.trace_summary --logdir /tmp/prof --top 15 --steps 3

or, from Python, `main(argv)`, which returns (device, total ms, {bucket:
ms}, {name: ms}), and `by_span(trace)`.
"""

from __future__ import annotations

import argparse
import bisect
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
    ("layered path", r"layer_fwd_kernel|layer_bwd_kernel|layer_kernel|view_pool_(fwd|bwd)_kernel"
     r"|layer_colsum|view_pool_colsum"),
    ("weight-gradient products", r"wgrad_products|wgrad_reduce"),
    ("lookup kernels", r"pyramid_(gather|scatter)_kernel|bilerp_(gather|scatter)_kernel"
     r"|grid_sampler"),
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


def by_span(trace: dict):
    """{innermost `pnt.*` span around the launch (None: none): device ms}
    of the trace's kernels, copies and sets (module docstring). With no
    span on the launching thread, the innermost one any thread holds then
    (the train step's `pnt.backward` for autograd's unlinked work)."""
    events = trace.get("traceEvents", [])
    flows: dict = defaultdict(dict)
    for e in events:
        if e.get("ph") in ("s", "f") and e.get("cat") in ("ac2g", "fwdbwd"):
            flows[e["cat"], e["id"]][e["ph"]] = (e["tid"], e["ts"])
    forward = {f["f"]: f["s"] for (cat, _), f in flows.items()
               if cat == "fwdbwd" and "s" in f and "f" in f}
    per_tid = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        at = (e["tid"], e["ts"])
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("pnt."):
            per_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"], None))
        elif e.get("cat") == "cpu_op" and at in forward:
            per_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], None, forward[at]))
    nested = {tid: _Nested(items) for tid, items in per_tid.items()}

    def span_of(tid, ts, linked=False):
        for _, _, name, fwd in nested[tid].around(ts) if tid in nested else ():
            found = name or (span_of(*fwd, linked=True) if fwd else None)
            if found:
                return found
        if linked:
            return None
        return next((name for other, n in nested.items() if other != tid
                     for _, _, name, _ in n.around(ts) if name), None)

    out: dict = defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e:
            launch = flows.get(("ac2g", e.get("args", {}).get("correlation")), {}).get("s")
            out[span_of(*launch) if launch else None] += float(e["dur"]) / 1e3
    return dict(out)


class _Nested:
    """Intervals of one thread that nest: (start, end, name, link)."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]
        self.parent, stack = [], []
        for i, item in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < item[0]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, ts):
        """The intervals open at `ts`, innermost first."""
        j = bisect.bisect_right(self.starts, ts) - 1
        while j >= 0 and self.items[j][1] < ts:
            j = self.parent[j]
        while j >= 0:
            yield self.items[j]
            j = self.parent[j]


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

    trace = load_trace(args.logdir)
    where, total_ms, per_op = summarize(trace)
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
    if where == "cuda":
        print(f"-- by innermost pnt.* span ({unit}, % of the total) --")
        for span, ms in sorted(by_span(trace).items(), key=lambda kv: -kv[1]):
            print(f"{ms / den:10.3f} {unit}  {100 * ms / max(total_ms, 1e-30):5.1f}%  {span or '(none)'}")
    return where, total_ms, buckets, per_op


if __name__ == "__main__":
    main()
