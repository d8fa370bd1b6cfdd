"""The unit plan of the two scatter-add kernels, made on the host.

`ops/pyramid.py:pyramid_scatter_add` and `ops/scatter.py:bilerp_scatter_add`
add `w * g` from (B, N) points onto float32 (B, H, W, C) maps, each point
with its K x K bilinear taps. One launch runs every unit of a call, one
block a unit (`csrc/scatter_accum.cuh`):

- a shared-memory unit takes one map b, a slice of a map's channels and a
  chunk of points, for a map whose (H, W, slice) f32 block fits
  `SMEM_UNIT` bytes with a slice of at least `SLICE_MIN` channels (32 bytes
  of each bf16 cotangent row, one sector). It zeroes that block in shared
  memory, adds each point's `w * g` there (each entry owned by one warp:
  every channel of one band of rows), and flushes the block into the
  gradient once, skipping zeros. A batch of points (`_batch`) is staged
  after the block: its taps (a base pixel, a base row, a mask and K x K
  weights a point, in whole 16-byte rows), its bf16 cotangent slices and
  each warp's list of the points it adds. A chunk holds at least
  8 x H x W points, so the flush (4 bytes a pixel and channel) is at most
  a quarter of the cotangent bytes the unit reads (2 bytes a point and
  channel), unless that leaves the card less than a wave of units;
- a global unit takes one map b and `WARPS x run` points of any other map.
  Each warp walks runs of `run` consecutive points for 32 x vec channels,
  sums `w * g` in registers while the points' tap base stays the same, and
  adds them with one vector reduction of `vec` floats a lane and tap when it
  changes (`vec` = 4 where the cotangent rows and the map allow 16-byte
  vectors, else 2).

Shared-memory segments come first in the launch: their units are the
longer ones. Every block of the launch gets the largest shared-memory
block of the plan, so `SMEM_UNIT` also sets how many blocks an SM holds.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "ScatterPlan", "Segment", "aligned", "count_reductions", "device_sms", "plan_scatter",
    "scatter_reference",
    "RUN", "SLICE_MAX", "SLICE_MIN", "SMEM_UNIT", "STAGE", "THREADS", "WARPS",
]

WARPS = 8  # warps a block (csrc/tile_common.cuh: WARPS)
THREADS = 32 * WARPS
RUN = 32  # consecutive points a warp of a global unit walks in order
SMEM_UNIT = 64 * 1024  # a unit's f32 block at most: two blocks an SM with their batches
STAGE = 32 * 1024  # bytes of a unit's bf16 cotangent stage (csrc/scatter_accum.cuh: SC_STAGE)
SLICE_MIN = 16  # channels: 32 bytes of a bf16 cotangent row
SLICE_MAX = THREADS  # channels a shared-memory unit takes: one band of rows


class Segment(NamedTuple):
    """The units of one map: unit `first + (b * nslices + s) * nchunks + k`
    takes map b, channel slice s and point chunk k."""

    map: int  # the map's index (the pyramid level)
    smem: bool  # shared-memory units, else global ones
    slice: int  # channels a unit takes (the last slice may take fewer)
    nslices: int
    chunk: int  # points a unit takes (the last chunk may take fewer)
    nchunks: int
    vec: int  # floats a vector reduction adds: 4 or 2
    first: int  # the segment's first unit
    units: int
    smem_bytes: int  # the unit's f32 block and batch (0 for global units)


class ScatterPlan(NamedTuple):
    segments: Tuple[Segment, ...]
    units: int  # blocks of the launch
    smem_bytes: int  # dynamic shared memory of every block
    run: int

    def as_ints(self) -> list:
        """The plan as the kernels' launchers read it: nseg, run, units,
        smem bytes, then map, smem, slice, nslices, chunk, nchunks, vec and
        first of each segment."""
        out = [len(self.segments), self.run, self.units, self.smem_bytes]
        for s in self.segments:
            out += [s.map, int(s.smem), s.slice, s.nslices, s.chunk, s.nchunks, s.vec, s.first]
        return out


def _slice(h: int, w: int, c: int) -> int:
    """Channels a shared-memory unit of an (h, w, c) map takes, 0 if none
    fits: all of them where they fit, else the most in multiples of 32
    (whole warps) or 16 within `SMEM_UNIT` and `SLICE_MAX`."""
    fit = min(SMEM_UNIT // (4 * h * w), SLICE_MAX)
    if c <= fit:
        return c
    if fit >= 32:
        return fit // 32 * 32
    return SLICE_MIN if fit >= SLICE_MIN else 0


def _batch(s: int) -> int:
    """Points a batch of a shared-memory unit of `s` channels takes: its
    stage within `STAGE`, whole warps, at most a thread a point."""
    return min(THREADS, max(32, STAGE // (2 * s) // 32 * 32))


def plan_scatter(
    maps: Sequence[Tuple[int, int, int]], nb: int, n: int, vec4: Sequence[bool],
    sms: int, taps: int,
) -> ScatterPlan:
    """Units for scattering N points of each of `nb` maps onto every map of
    `maps` ((H, W, C) each), `taps` x `taps` taps a point.

    :param vec4 per map, whether its cotangent rows (and channel offset in
        them) allow 8-byte loads and its C 16-byte reductions
    :param sms the card's SMs: a map's shared-memory units make at least a
        wave where the points allow it
    """
    rec = 4 * -(-(taps * taps + 3) // 4)  # a point's taps (csrc/scatter_accum.cuh: sc_rec)
    smem_segs, global_segs = [], []
    for i, (h, w, c) in enumerate(maps):
        s = _slice(h, w, c)
        if s:
            nslices = -(-c // s)
            nchunks = -(-n // max(8 * h * w, WARPS * RUN))
            wave = -(-sms // (nb * nslices))
            if nchunks < wave:
                # more, smaller chunks while the flush stays below the
                # cotangent bytes read (2 x H x W points a chunk)
                nchunks = max(nchunks, min(wave, n // max(2 * h * w, 1)))
            chunk = -(-n // max(nchunks, 1))
            vec = 4 if c % 4 == 0 and s % 4 == 0 else 2
            block = 16 * -(-(h * w * s) // 4)  # the batch starts on 16 bytes
            nbatch = _batch(s)
            # a batch: its taps, bf16 cotangents, and each warp's list of its points
            batch = nbatch * (4 * rec + 2 * s) + 4 * WARPS + 2 * WARPS * nbatch
            smem_segs.append((i, True, s, nslices, chunk, block + batch, vec))
        else:
            chunk = WARPS * RUN
            vec = 4 if vec4[i] and c % 4 == 0 else 2
            global_segs.append((i, False, c, 1, chunk, 0, vec))
    segments, first = [], 0
    for i, smem, s, nslices, chunk, nbytes, vec in smem_segs + global_segs:
        nchunks = -(-n // chunk) if n else 0
        units = nb * nslices * nchunks
        segments.append(Segment(i, smem, s, nslices, chunk, nchunks, vec, first, units, nbytes))
        first += units
    smem_bytes = max([s.smem_bytes for s in segments], default=0)
    return ScatterPlan(tuple(segments), first, smem_bytes, RUN)


@functools.lru_cache(maxsize=None)
def device_sms(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """t, or a copy of it if its data does not start on `nbytes` bytes (a
    view into a larger tensor may not): the kernels load whole vectors."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def count_reductions(plan: ScatterPlan, maps, taps) -> dict:
    """The reductions one launch of `plan` makes, counted from its points'
    taps: `scalar`, one f32 atomic into device memory a channel and nonzero
    tap (the kernels' earlier design); `vector`, the global units' vector
    reductions after the run merge; `flush`, the shared-memory units' flush
    reductions (every channel of each pixel that a unit's chunk taps, zeros
    aside); `shared`, their shared-memory atomics.

    :param maps (H, W, C) of each map, as planned
    :param taps per map, (flat pixel indices, weights), each (B, N, K*K),
        the weights zero for a tap that adds nothing (`_level_taps`, `_taps`)
    """
    out = dict(scalar=0, vector=0, flush=0, shared=0)
    for seg in plan.segments:
        h, w, c = maps[seg.map]
        idx, wt = taps[seg.map]
        b, n, t = idx.shape
        nz = wt != 0
        ntaps = int(nz.sum())
        out["scalar"] += ntaps * c
        if seg.smem:
            out["shared"] += ntaps * c
            chunk = torch.arange(n, device=idx.device) // seg.chunk
            key = (torch.arange(b, device=idx.device)[:, None, None] * seg.nchunks
                   + chunk[None, :, None]) * (h * w) + idx
            pixels = torch.unique(key[nz]).numel()
            lanes = sum(
                math.ceil(min(seg.slice, c - k * seg.slice) / seg.vec) for k in range(seg.nslices)
            )
            out["flush"] += pixels * lanes
        else:
            base = idx[..., 0]  # tap (0, 0) is the base, never past the map
            brk = torch.ones_like(base, dtype=torch.bool)
            brk[:, 1:] = base[:, 1:] != base[:, :-1]
            brk[:, :: plan.run] = True  # runs start at multiples of `run`
            run_id = torch.cumsum(brk.flatten().long(), 0) - 1
            merged = torch.zeros((int(run_id[-1]) + 1, t), dtype=torch.long, device=idx.device)
            merged.scatter_reduce_(0, run_id[:, None].expand(-1, t), nz.reshape(-1, t).long(), "amax")
            out["vector"] += int(merged.sum()) * math.ceil(c / seg.vec)
    return out


def scatter_reference(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor, pixels: int):
    """The scatter of `g` (B, N, C) through the taps (idx, w), each (B, N, T)
    as `count_reductions` takes them, onto (B, pixels, C), in float64; and,
    element by element, the bound of any float32 evaluation of that sum:
    n * 2^-24 * sum |w * g| over its n nonzero terms. Each term, a product of
    two bf16 values, is exact in float32, and each of the n - 1 additions
    rounds once, in whatever order (registers, shared memory, reductions
    into device memory), so a kernel's float32 sums are within the bound
    and a term dropped or added twice is not. Where a weight is not a bf16
    value (the float32 taps of a map past 8,192 pixels), each term's product
    may round once more: 2n * 2^-24 * sum |w * g|. Returns (sum, bound)."""
    b, n, t = idx.shape
    c = g.shape[-1]
    roundings = 1.0 if bool((w.to(torch.bfloat16).float() == w).all()) else 2.0
    g = g.double()
    nonzero = (g != 0).double()
    out = torch.zeros((b * pixels, c), dtype=torch.float64, device=g.device)
    mag, cnt = torch.zeros_like(out), torch.zeros_like(out)
    rows = torch.arange(b, device=g.device)[:, None] * pixels
    for k in range(t):
        at = (rows + idx[..., k]).reshape(-1)
        wk = w[..., k, None].double()
        term = wk * g
        out.index_add_(0, at, term.reshape(-1, c))
        mag.index_add_(0, at, term.abs().reshape(-1, c))
        cnt.index_add_(0, at, ((wk != 0).double() * nonzero).reshape(-1, c))
    return out.reshape(b, pixels, c), (roundings * cnt * 2.0 ** -24 * mag).reshape(b, pixels, c)
