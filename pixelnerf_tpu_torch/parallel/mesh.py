"""Process meshes over `torch.distributed`: data and ray parallel training.

Counterpart of `pixelnerf_tpu/parallel/mesh.py`'s shard_map path
(`shard_train_step_shmap` with a step built with `pmean_axes`). A mesh
`data:a,rays:b` is a world of a*b ranks, one process each; rank r sits at
data index r // b and rays index r % b.

* Each rank takes SB/a objects (its data index's block) and R/b rays of
  each (its rays index's block), and draws from a generator folded with
  its two indices, as the JAX step folds its key with `axis_index`. Ranks
  along `rays` encode the same objects, as under shard_map.
* After backward the gradients, the BatchNorm running statistics and the
  logged losses are averaged over the world (JAX's `pmean`), so every rank
  applies the same optimizer update and the parameters stay replicated.
  Train-mode BatchNorm normalizes with each rank's own batch statistics,
  as JAX's shard_map does (not sync-BN).
* The kernels run on each rank's local slice, as the Pallas kernels run
  per shard under shard_map. JAX's other mode, GSPMD auto-partitioning
  (`--spmd_mode gspmd`), exists only because GSPMD cannot split a
  pallas_call; it has no counterpart here.

Backend rule (`backend_for`): NCCL when every local rank has a card of its
own, gloo when ranks share a card or run on the CPU. NCCL refuses two
ranks on one card; gloo all-reduces CUDA tensors through the host. The
rule is decided before `init_process_group`, and a failed init raises:
nothing retries with another backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "RAYS_AXIS",
    "Mesh",
    "backend_for",
    "init_distributed",
    "make_mesh",
    "parse_mesh_spec",
    "shard_batch",
    "world_size",
    "wrap_pad",
]

DATA_AXIS = "data"
RAYS_AXIS = "rays"

# batch keys split over the object axis; (SB, R, ...) injected ray
# batches split over both (the JAX package's shard_map specs)
_DATA_SHARDED_KEYS = frozenset({
    "images", "images_u8", "image_ord", "poses", "focal", "c", "bbox",
    "src_images", "src_poses", "src_c", "z_bounds",
})
_RAY_SHARDED_KEYS = frozenset({"rays", "rgb_gt"})


def world_size() -> int:
    """The initialized process group's size, else `WORLD_SIZE` (a
    launcher's), else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def parse_mesh_spec(spec: str, n_devices: Optional[int] = None) -> Dict[str, int]:
    """Parse 'data:2,rays:4' into {'data': 2, 'rays': 4}.

    The empty spec puts every rank on the rays axis. The axes' product must
    equal `n_devices`, the world size by default (of the initialized
    process group, else `WORLD_SIZE`, else 1).
    """
    if n_devices is None:
        n_devices = world_size()
    if not spec:
        return {DATA_AXIS: 1, RAYS_AXIS: n_devices}
    out: Dict[str, int] = {DATA_AXIS: 1, RAYS_AXIS: 1}
    for part in spec.split(","):
        name, size = part.split(":")
        name = name.strip()
        if name not in out:
            raise ValueError(f"Unknown mesh axis {name!r} (use data/rays)")
        out[name] = int(size)
    total = out[DATA_AXIS] * out[RAYS_AXIS]
    if total != n_devices:
        raise ValueError(f"Mesh {out} covers {total} devices but {n_devices} are available")
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in a (data, rays) mesh and the group it reduces over.

    :param group the process group (None: the default group)
    """

    data: int
    rays: int
    rank: int
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.rays

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, RAYS_AXIS: self.rays}

    @property
    def data_index(self) -> int:
        return self.rank // self.rays

    @property
    def rays_index(self) -> int:
        return self.rank % self.rays

    def fold(self, generator: Optional[torch.Generator], device) -> torch.Generator:
        """A generator for this rank's draws: a seed hashed from the state of
        `generator` (the same on every rank) and the rank's two indices, as
        JAX folds the step's key with each axis index. `generator` then
        advances by one draw, so the next call folds a new state."""
        if generator is None:
            generator = torch.default_generator
        state = generator.get_state().numpy().tobytes()
        digest = hashlib.blake2b(
            state + struct.pack("<qq", self.data_index, self.rays_index), digest_size=8
        ).digest()
        torch.empty(1, device=generator.device).uniform_(generator=generator)
        out = torch.Generator(device=device)
        out.manual_seed(int.from_bytes(digest, "little") >> 1)
        return out

    def all_reduce_mean_(self, tensors: List[torch.Tensor]) -> None:
        """Average `tensors` over the mesh's ranks in place: one flat
        all-reduce per (device, dtype), summed then divided by the size, as
        `lax.pmean`. Every rank gets the same bits back."""
        buckets: Dict[tuple, List[torch.Tensor]] = {}
        for t in tensors:
            buckets.setdefault((t.device, t.dtype), []).append(t)
        for ts in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            flat.div_(self.size)
            offset = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset : offset + n].view_as(t))
                offset += n


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None, rank: Optional[int] = None, group=None
) -> Mesh:
    """This rank's `Mesh`; by default every rank of the initialized group
    on the rays axis."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: 1, RAYS_AXIS: world}
    if rank is None:
        rank = dist.get_rank(group) if dist.is_initialized() else 0
    mesh = Mesh(axis_sizes[DATA_AXIS], axis_sizes[RAYS_AXIS], rank, group)
    if dist.is_initialized() and mesh.size != world:
        raise ValueError(f"Mesh {mesh.shape} covers {mesh.size} ranks but the world has {world}")
    return mesh


def backend_for(device_type: str, local_world_size: int, device_count: int) -> str:
    """'nccl' when every local rank has a card of its own, else 'gloo'
    (ranks sharing a card, or on the CPU)."""
    if device_type == "cuda" and 0 < local_world_size <= device_count:
        return "nccl"
    return "gloo"


def init_distributed(device_type: str) -> str:
    """Join the world that `torchrun` describes in the environment (RANK,
    WORLD_SIZE, LOCAL_WORLD_SIZE; MASTER_ADDR/MASTER_PORT for the env://
    rendezvous) with the backend `backend_for` names, and return it.
    Raises if the group cannot be made."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = backend_for(device_type, local_world, count)
    print(f"distributed: rank {rank} of {world}, {local_world} local rank(s) on "
          f"{count} card(s): backend {backend}")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return backend


def wrap_pad(batch: Dict, multiple: int) -> Dict:
    """Wrap-pad the object axis of the data-sharded keys to a multiple of
    `multiple` (the JAX CLI's padding of a partial batch: the first objects
    repeat)."""
    sb = next(v.shape[0] for k, v in batch.items() if k in _DATA_SHARDED_KEYS | _RAY_SHARDED_KEYS)
    pad = (-sb) % multiple
    if not pad:
        return batch
    idx = np.resize(np.arange(sb), sb + pad)
    take = lambda v: v[torch.from_numpy(idx).to(v.device)] if torch.is_tensor(v) else v[idx]
    return {k: take(v) if k in _DATA_SHARDED_KEYS | _RAY_SHARDED_KEYS else v
            for k, v in batch.items()}


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's slice of a global batch (numpy arrays or tensors): the
    data index's block of objects, wrap-padded to a multiple of the data
    axis first, and of injected rays also the rays index's block of rays.
    Other keys are replicated."""
    batch = wrap_pad(batch, mesh.data)
    out = {}
    for k, v in batch.items():
        if k in _DATA_SHARDED_KEYS or k in _RAY_SHARDED_KEYS:
            n = v.shape[0] // mesh.data
            v = v[mesh.data_index * n : (mesh.data_index + 1) * n]
        if k in _RAY_SHARDED_KEYS:
            r = v.shape[1]
            if r % mesh.rays:
                raise ValueError(f"{k}: {r} rays do not split over {mesh.rays} rays shards")
            n = r // mesh.rays
            v = v[:, mesh.rays_index * n : (mesh.rays_index + 1) * n]
        out[k] = v
    return out
