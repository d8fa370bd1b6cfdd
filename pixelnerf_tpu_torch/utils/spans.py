"""Named host ranges at the port's layer boundaries, for `torch.profiler`.

`span(name, args)` is `torch.profiler.record_function(name, args)` while
a profiler records, so the range lands on the profiler's own clock beside
the device operations the host launched inside it (kineto links each
launch to its kernel). Otherwise it is one shared no-op context: a flag
check, with no dispatcher call, allocation or device sync. Every name
starts with `pnt.`, the prefix of the port's C entry points:

    pnt.step (args: optimizer steps taken) > pnt.batch, pnt.encode,
        pnt.render, pnt.loss, pnt.backward, pnt.adam
    pnt.render_full (args: seed) > pnt.chunk > pnt.render
    pnt.render > pnt.sample, pnt.query.coarse, pnt.query.fine, pnt.composite
    pnt.query.* > pnt.lookup, pnt.mlp.fwd
    pnt.mlp.bwd, pnt.lookup.bwd: the backward of the MLP's and the
        lookup's autograd Functions (on autograd's device thread)

Aten backward work runs outside any of them; the profiler links it to its
forward operation by sequence number and forward thread id, which a
reader of the trace follows to the forward's span.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_NOOP = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str, args=None):
    """A `with` context naming a range of the port's work in a profile;
    `args`, where given, is recorded as its string."""
    if _recording():
        return torch.profiler.record_function(name, None if args is None else str(args))
    return _NOOP
