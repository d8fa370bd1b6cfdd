"""The traced window: device operations, busy time, idle gaps and the
benchmark's own spans, from `torch.profiler`'s records.

The window runs inside a `bench.window` span, and the benchmark marks its
own calls into the program with `bench.*` spans (`bench.step`,
`bench.encode`, `bench.render`, `bench.fetch`). A device operation is
attributed to the span in which the host launched it (the launch's
correlation id), and an idle gap of the device to what the host was doing
when it launched the operation that ends the gap: the innermost host
operation around that launch, under its `bench.*` span.

`BUCKETS` is a frozen copy of the port's `tools/trace_summary.py`
`DEFAULT_BUCKETS` (first matching pattern wins), with the lookup bucket
widened to PyTorch's `grid_sampler` kernels, which a map too large for the
pyramid kernels takes.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import List, Optional, Tuple

BUCKETS = (
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
    ("host/device transfers", r"memcpy|memset|Memcpy|Memset"),
    ("elementwise (sampling, compositing, Adam)", r"elementwise|vectorized|reduce|index|scatter|"
     r"gather|copy|fill|cat|softmax|cumsum|batch_norm|foreach|unrolled|distribution"),
)
MLP_BUCKETS = ("block chains", "layered path", "weight-gradient products")
FIELD_BUCKETS = ("fused field kernels",)
_COMPILED = [(label, re.compile(pat, re.IGNORECASE)) for label, pat in BUCKETS]
RUNTIME_RE = re.compile(r"^(cuda|cu)[A-Z]")


def bucket_of(name: str) -> str:
    for label, pat in _COMPILED:
        if pat.search(name):
            return label
    return "other"


class DeviceOp:
    __slots__ = ("name", "start", "end", "span", "bucket")

    def __init__(self, name, start, end, span):
        self.name, self.start, self.end, self.span = name, start, end, span
        self.bucket = bucket_of(name)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Trace:
    """What a traced window shows. Times in seconds."""

    def __init__(self, ops: List[DeviceOp], window: Tuple[int, int], gaps: List[Tuple[str, float]]):
        self.ops = ops
        self.window_ns = window
        self.window_s = (window[1] - window[0]) * 1e-9
        self.busy_s = _union_ns([(o.start, o.end) for o in ops], window) * 1e-9
        self.gaps = gaps

    def seconds(self, buckets=None, span: Optional[str] = None, exclude=()) -> float:
        """Device seconds of the operations in `buckets` (all when None),
        launched inside `span` (any when None), outside `exclude`."""
        return sum(o.seconds for o in self.ops
                   if (buckets is None or o.bucket in buckets) and o.bucket not in exclude
                   and (span is None or o.span == span))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        per = defaultdict(float)
        for o in self.ops:
            per[o.name] += o.seconds
        return sorted(per.items(), key=lambda kv: -kv[1])[:n]


def _union_ns(intervals, window) -> int:
    lo, hi = window
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def read_profile(prof, window_span: str = "bench.window", gaps: int = 10) -> Trace:
    """A `Trace` of a `torch.profiler.profile` run with CPU and CUDA
    activities, over the interval of its `window_span` span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        (device if e.device_type() == DeviceType.CUDA else host).append(e)
    window = next(((e.start_ns(), e.end_ns()) for e in host if e.name() == window_span), None)
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    # the profiler mirrors host spans (record_function, the optimizer's
    # step) onto the device's timeline; they are not device operations
    annotations = {e.name() for e in host if e.is_user_annotation()}
    device = [e for e in device
              if not e.is_user_annotation() and e.name() not in annotations
              and not e.name().startswith("bench.")]

    launches = {e.correlation_id(): e for e in host if RUNTIME_RE.match(e.name())}
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                   if e.name().startswith("bench.") and e.name() != window_span)
    span_starts = [s for s, _, _ in spans]

    def span_at(t):
        i = bisect.bisect_right(span_starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else None

    ops = []
    for e in device:
        launch = _launch_of(e, launches)
        t = launch.start_ns() if launch is not None else None
        ops.append(DeviceOp(e.name(), e.start_ns(), e.end_ns(),
                            span_at(t) if t is not None else None))
    ops = [o for o in ops if o.end > window[0] and o.start < window[1]]
    ops.sort(key=lambda o: o.start)
    return Trace(ops, window, _idle_gaps(ops, window, host, launches, device, gaps, span_at))


def _launch_of(event, launches):
    """The host's launch of a device operation, by correlation id."""
    for cid in (event.correlation_id(), event.linked_correlation_id()):
        if cid and cid in launches:
            return launches[cid]
    return None


def _idle_gaps(ops, window, host, launches, device, n, span_at) -> List[Tuple[str, float]]:
    """The `n` longest intervals of the window with no device operation,
    named by the host operation that launched the one ending the gap."""
    found, end = [], window[0]
    for i, o in enumerate(ops):
        if o.start > end:
            found.append((o.start - end, i))
        end = max(end, o.end)
    tail = window[1] - end if window[1] > end else 0
    found.sort(reverse=True)
    by_start = {}
    for e in device:
        by_start.setdefault((e.start_ns(), e.name()), e)
    cpu_ops = sorted(((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()) for e in host
                      if not RUNTIME_RE.match(e.name()) and not e.name().startswith("bench.")),
                     key=lambda x: (x[0], -x[1]))
    starts = [c[0] for c in cpu_ops]
    out = []
    for length, i in found[:n]:
        o = ops[i]
        dev_event = by_start.get((o.start, o.name))
        launch = _launch_of(dev_event, launches) if dev_event else None
        what = "unlaunched"
        if launch is not None:
            t, tid = launch.start_ns(), launch.start_thread_id()
            inner = None
            j = bisect.bisect_right(starts, t) - 1
            # the innermost enclosing host operation on the launching thread:
            # the latest-starting one that still covers t
            while j >= 0 and t - cpu_ops[j][0] < 10 ** 10:
                s, e, name, th = cpu_ops[j]
                if th == tid and e >= t:
                    inner = name
                    break
                j -= 1
            what = f"{span_at(t) or 'host'}/{inner or launch.name()}"
        out.append((what, length * 1e-9))
    if tail and (len(out) < n or tail * 1e-9 > out[-1][1]):
        out.append(("window end/sync", tail * 1e-9))
        out = sorted(out, key=lambda kv: -kv[1])[:n]
    return out
