"""The unit plan of the two gather kernels, made on the host.

`ops/pyramid.py:pyramid_gather` and `ops/scatter.py:bilerp_gather` sum
each of (B, N) points' K x K taps of one or more bf16 (B, H, W, C) maps
into the point's output row. One launch runs every unit of a call, one
block a unit (`csrc/gather_tile.cuh`): map b and a chunk of `chunk`
consecutive points, split into `WARPS x 32 / lanes` streams of consecutive
points, one a group of `lanes` lanes. Within a unit:

- a map whose bf16 (H, W, C) block fits `STAGE_BYTES` of shared memory
  (with the block's table of its points' taps and the smaller maps staged
  before it) and has no more pixels than the unit has points is copied
  into shared memory once and its taps are read from there (`soff`, its
  byte offset; -1 for none);
- map 0 (the fine grid, a 2 x 2 window) keeps its tap rows in registers
  while a stream's points keep their tap base (`cached`), where it is not
  staged and a lane's channel groups fit the cache (`rows x lanes x vec`
  channels);
- every other map loads the rows of its nonzero taps from device memory.

`vec` is 8 (16-byte loads and stores) where every map's channel count is a
multiple of 8 and the maps start on 16 bytes, else 2. Chunks make about
one wave of `BLOCKS_PER_SM` blocks on every SM, and at least `MIN_CHUNK`
points where the call has them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "GatherPlan", "count_tap_bytes", "plan_gather", "table_bytes",
    "BLOCKS_PER_SM", "MIN_CHUNK", "STAGE_BYTES", "WARPS",
]

WARPS = 8  # warps a block (csrc/tile_common.cuh: WARPS)
BLOCKS_PER_SM = 2  # csrc/gather_tile.cuh: GT_MIN_BLOCKS
STAGE_BYTES = 112 * 1024  # a block's shared memory at most: two blocks an SM
MIN_CHUNK = 256  # points a unit takes at least, where the call has them


def table_bytes(nmaps: int) -> int:
    """The block's table of its points' taps in shared memory
    (csrc/gather_tile.cuh: GtBatch): a record a thread of a tap base and K x K
    bf16 weights a map, K = 2 for map 0 and 3 for the others, two weights a
    word; none for one map, whose records pass by shuffle."""
    return 4 * 32 * WARPS * (3 + 6 * (nmaps - 1)) if nmaps > 1 else 0


class GatherPlan(NamedTuple):
    chunk: int  # points a unit takes (the last chunk of a map may take fewer)
    nchunks: int
    units: int  # blocks of the launch: maps x chunks
    smem_bytes: int  # shared memory of every block: the taps' table, the staged maps
    vec: int  # bf16 channels a lane loads at once: 8 or 2
    cached: bool  # map 0's rows in the register cache
    soff: Tuple[int, ...]  # each map's byte offset in shared memory, -1: not staged
    lanes: int  # lanes a point

    def as_ints(self) -> list:
        """The plan as the kernels' launchers read it
        (`csrc/gather_tile.cuh:gather_plan`)."""
        return [self.chunk, self.nchunks, self.units, self.smem_bytes, self.vec,
                int(self.cached)] + list(self.soff)

    @property
    def streams(self) -> int:
        """Streams of consecutive points a unit splits into."""
        return WARPS * (32 // self.lanes)


def plan_gather(
    maps: Sequence[Tuple[int, int, int]], nb: int, n: int, sms: int, lanes: int, rows: int,
    vec16: bool,
) -> GatherPlan:
    """Units for gathering N points of each of `nb` maps from every map of
    `maps` ((H, W, C) each, map 0 the fine grid).

    :param sms the card's SMs: the chunks make about one wave of blocks
    :param lanes lanes a point (16 for the pyramid, 32 for the bilerp map)
    :param rows channel groups of map 0 a lane caches
    :param vec16 whether every map starts on 16 bytes
    """
    vec = 8 if vec16 and all(c % 8 == 0 for _, _, c in maps) else 2
    chunk = min(max(MIN_CHUNK, -(-nb * n // (BLOCKS_PER_SM * sms))), max(n, 1))
    nchunks = -(-n // chunk)
    soff, used = [-1] * len(maps), table_bytes(len(maps))
    # the smallest maps first: the most of them within the budget
    for i in sorted(range(len(maps)), key=lambda i: math.prod(maps[i])):
        h, w, c = maps[i]
        nbytes = 16 * -(-2 * h * w * c // 16)
        if h * w <= chunk and used + nbytes <= STAGE_BYTES:
            soff[i], used = used, used + nbytes
    cached = soff[0] < 0 and maps[0][2] <= rows * lanes * vec
    return GatherPlan(chunk, nchunks, nb * nchunks, used, vec, cached, tuple(soff), lanes)


def count_tap_bytes(plan: GatherPlan, maps, taps) -> dict:
    """The bytes of tap rows one launch of `plan` reads, counted from its
    points' taps: `window`, every tap of each map's K x K window (the
    kernels' earlier design, which skipped only taps past the map's edge);
    `nonzero`, the taps with a nonzero weight; of those, `shared` from the
    staged maps and `device` from device memory (L2), after map 0's
    register cache has kept the rows a stream already holds; `staged`, the
    bytes copied into shared memory.

    :param maps (H, W, C) of each map, as planned
    :param taps per map, (flat pixel indices, weights), each (B, N, K*K),
        the weights zero for a tap that adds nothing (`_level_taps`, `_taps`)
    """
    out = dict(window=0, nonzero=0, shared=0, device=0, staged=0)
    for i, ((h, w, c), (idx, wt)) in enumerate(zip(maps, taps)):
        row = 2 * c
        b, n, t = wt.shape
        nz = wt != 0
        nonzero = int(nz.sum()) * row
        out["window"] += b * n * t * row
        out["nonzero"] += nonzero
        if plan.soff[i] >= 0:
            out["shared"] += nonzero
            out["staged"] += plan.units * h * w * row
        elif i == 0 and plan.cached:
            out["device"] += _cached_rows(plan, idx[..., 0], nz) * row
        else:
            out["device"] += nonzero
    return out


def _cached_rows(plan: GatherPlan, base, nz) -> int:
    """Rows map 0's register cache loads: a tap's row at a point whose tap
    has a nonzero weight, unless an earlier point of the same stream and the
    same tap base since the base last changed has loaded it."""
    b, n = base.shape
    q = torch.arange(n, device=base.device)
    first = q % plan.chunk  # the point's place in its unit
    ulen = torch.clamp(n - (q - first), max=plan.chunk)
    slen = -(-ulen // plan.streams)
    start = torch.zeros_like(base, dtype=torch.bool)
    start[:, 1:] = base[:, 1:] != base[:, :-1]
    start |= (first % slen == 0)[None, :]  # a stream's first point
    epoch = torch.cumsum(start.flatten().long(), 0).reshape(b, n)
    rows = 0
    for k in range(nz.shape[-1]):
        e = epoch[nz[..., k]]  # in point order
        if e.numel():
            rows += 1 + int((e[1:] != e[:-1]).sum())
    return rows
