"""The program's own spans in a traced window: device time and idle gaps
put down to the `pnt.*` range in which the host launched them.

The port opens a `pnt.*` range (`pixelnerf_tpu_torch/utils/spans.py`) at
each layer boundary while a profiler records. This reads the same
`torch.profiler` run as `harness/trace.py:read_profile`, over the same
window, with the same device operations (the profiler's device-side
copies of host annotations left out), and puts each operation down to:

- the innermost `pnt.*` span around its launch on the launching thread;
- where the innermost context of the launch is an autograd node (aten
  backward work, which runs outside the forward's spans, on autograd's
  device thread on the card), the span of the forward operation that
  recorded the node: the profiler gives the node's event the forward's
  sequence number and thread id. Where a node has no such link
  (AccumulateGrad), the next context outward decides;
- with nothing on the launching thread, the innermost `pnt.*` span that
  any thread holds open at the launch (the step's `pnt.backward` for
  autograd's unlinked work).

An idle gap of the device is put down to the span of the operation that
ends it. Spans nest on a thread, so the innermost one around an instant
is the latest-starting one still open.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from harness.trace import RUNTIME_RE, _launch_of, bucket_of

PREFIX = "pnt."


@dataclasses.dataclass
class SpanOp:
    """One device operation: name, bucket, device interval (ns), the
    `bench.*` span the host launched it in, its `pnt.*` span, and whether
    that span came through an autograd node's link to its forward."""

    name: str
    start: int
    end: int
    bench: Optional[str]
    span: Optional[str]
    linked: bool = False

    @property
    def bucket(self) -> str:
        return bucket_of(self.name)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


@dataclasses.dataclass
class Spans:
    """A traced window by `pnt.*` span. Times in seconds.

    :param ops the window's device operations, by start
    :param gaps (seconds, the operation that ends the gap) for every
        interval of the window with no device operation before its last one
    :param opened how many times each `pnt.*` span opened in the window
    """

    ops: List[SpanOp]
    gaps: List[Tuple[float, SpanOp]]
    opened: Dict[str, int]

    def seconds(self, span: Optional[str] = None, bench: Optional[str] = None,
                buckets=None, exclude=()) -> float:
        """Device seconds put down to `span` (any `pnt.*` span when None),
        launched in `bench` (any when None), in `buckets`, outside `exclude`."""
        return sum(o.seconds for o in self.ops
                   if (o.span == span if span is not None else o.span is not None)
                   and (bench is None or o.bench == bench)
                   and (buckets is None or o.bucket in buckets) and o.bucket not in exclude)

    def by_span(self, bench: Optional[str] = None, linked: bool = False) -> Dict[str, float]:
        """Device seconds by span; with `linked`, the backward's share
        (through a forward link) apart, as `<span> (backward)`."""
        out: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            if bench is None or o.bench == bench:
                out[_key(o, linked)] += o.seconds
        return dict(out)

    def idle_by_span(self, linked: bool = False) -> Dict[str, float]:
        """Idle seconds by the span of the operation that ends each gap."""
        out: Dict[str, float] = defaultdict(float)
        for length, o in self.gaps:
            out[_key(o, linked)] += length
        return dict(out)

    def coverage(self, bench: str) -> Optional[float]:
        """The share of the device time launched in `bench` that is put
        down to a `pnt.*` span."""
        total = sum(o.seconds for o in self.ops if o.bench == bench)
        return self.seconds(bench=bench) / total if total > 0 else None


def _key(op: SpanOp, linked: bool) -> str:
    name = str(op.span)
    return f"{name} (backward)" if linked and op.linked else name


class _Contexts:
    """The `pnt.*` spans and autograd nodes of one thread, nested."""

    def __init__(self, items):
        # (start, end, span name or None, node's (thread, sequence) or None)
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]
        self.parent, stack = [], []
        for i, (s, e, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, t: int):
        """The contexts open at `t`, innermost first."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.items[j][1] < t:
            j = self.parent[j]
        while j >= 0:
            yield self.items[j]
            j = self.parent[j]


class _Index:
    def __init__(self, host):
        per_thread = defaultdict(list)
        self.forward = {}
        for e in host:
            name, tid = e.name(), e.start_thread_id()
            if name.startswith(PREFIX):
                per_thread[tid].append((e.start_ns(), e.end_ns(), name, None))
            elif e.fwd_thread_id() > 0 and e.sequence_nr() >= 0:
                per_thread[tid].append((e.start_ns(), e.end_ns(), None,
                                        (e.fwd_thread_id(), e.sequence_nr())))
            elif e.sequence_nr() >= 0:
                # the last forward operation of a sequence number recorded its node
                key = (tid, e.sequence_nr())
                if e.start_ns() >= self.forward.get(key, -1):
                    self.forward[key] = e.start_ns()
        self.threads = {tid: _Contexts(items) for tid, items in per_thread.items()}

    def span_of(self, t: int, tid: int) -> Optional[str]:
        return self.attribute(t, tid)[0]

    def attribute(self, t: int, tid: int, depth: int = 0) -> Tuple[Optional[str], bool]:
        """(span, whether it came through a forward link) of an instant
        `t` on thread `tid`."""
        ctx = self.threads.get(tid)
        for _, _, name, link in (ctx.around(t) if ctx else ()):
            if name is not None:
                return name, depth > 0
            fwd = self.forward.get(link)
            if fwd is not None and depth < 8:
                found = self.attribute(fwd, link[0], depth + 1)
                if found[0] is not None:
                    return found[0], True
        if depth:
            return None, False
        for other, c in self.threads.items():
            if other != tid:
                for _, _, name, _ in c.around(t):
                    if name is not None:
                        return name, False
        return None, False


def read_spans(prof, window_span: str = "bench.window") -> Spans:
    """`Spans` of a `torch.profiler.profile` run with CPU and CUDA
    activities, over the interval of its `window_span` span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        (device if e.device_type() == DeviceType.CUDA else host).append(e)
    window = next(((e.start_ns(), e.end_ns()) for e in host if e.name() == window_span), None)
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    annotations = {e.name() for e in host if e.is_user_annotation()}
    device = [e for e in device
              if not e.is_user_annotation() and e.name() not in annotations
              and not e.name().startswith("bench.")]
    launches = {e.correlation_id(): e for e in host if RUNTIME_RE.match(e.name())}
    benches = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                     if e.name().startswith("bench.") and e.name() != window_span)
    bench_starts = [s for s, _, _ in benches]

    def bench_at(t):
        i = bisect.bisect_right(bench_starts, t) - 1
        return benches[i][2] if i >= 0 and benches[i][1] >= t else None

    index = _Index(host)
    ops = []
    for e in device:
        if not (e.end_ns() > window[0] and e.start_ns() < window[1]):
            continue
        launch = _launch_of(e, launches)
        bench, span, linked = None, None, False
        if launch is not None:
            t = launch.start_ns()
            bench = bench_at(t)
            span, linked = index.attribute(t, launch.start_thread_id())
        ops.append(SpanOp(e.name(), e.start_ns(), e.end_ns(), bench, span, linked))
    ops.sort(key=lambda o: o.start)
    gaps, end = [], window[0]
    for o in ops:
        if o.start > end:
            gaps.append(((o.start - end) * 1e-9, o))
        end = max(end, o.end)
    opened = defaultdict(int)
    for e in host:
        if e.name().startswith(PREFIX) and window[0] <= e.start_ns() <= window[1]:
            opened[e.name()] += 1
    return Spans(ops, gaps, dict(opened))



WGRAD = {"weight-gradient products"}


def readings(spans: Spans, kind: str, units: int, parts: Optional[Dict[str, float]] = None):
    """The per-layer readings the spans give, by metric name; None where
    the window holds no `pnt.*` span for it (a program without spans).

    Training (`parts`: `mlp_parts.train_parts`): the stash forward's,
    the backward chain's and `wgrad`'s least time over the device time
    put down to `pnt.mlp.fwd`, to `pnt.mlp.bwd` outside the `wgrad`
    kernels, and to those kernels in `pnt.mlp.bwd` (%); device ms a step
    in `pnt.encode` (forward and backward) and in `pnt.adam`, and idle ms
    a step in gaps that a launch under `pnt.adam` ends. Views: device ms
    a view in `pnt.lookup`."""
    per_unit = lambda s: 1e3 * s / units if s > 0 and units else None
    if kind == "view":
        return {"lookup_ms.view": per_unit(spans.seconds("pnt.lookup"))}
    share = lambda least, s: 100.0 * least * units / s if s > 0 else None
    return {
        "mlp_fwd_roofline.train": share(parts["mlp_fwd_least_s"], spans.seconds("pnt.mlp.fwd")),
        "mlp_chain_roofline.train": share(parts["mlp_chain_least_s"],
                                          spans.seconds("pnt.mlp.bwd", exclude=WGRAD)),
        "wgrad_roofline.train": share(parts["mlp_wgrad_least_s"],
                                      spans.seconds("pnt.mlp.bwd", buckets=WGRAD)),
        "encode_ms.train": per_unit(spans.seconds("pnt.encode")),
        "adam_ms.train": per_unit(spans.seconds("pnt.adam")),
        "adam_idle_ms.train": per_unit(spans.idle_by_span().get("pnt.adam", 0.0)),
    }
