"""Host-side batch loader: collation, shuffling, source-view selection.

Counterpart of `pixelnerf_tpu/data/loader.py`: a shuffled batcher over a
map-style dataset with an optional background thread that loads one batch
ahead (the reference's torch DataLoader ran with num_workers=0,
trainlib/trainer.py:17-30).

`make_step_batch` is the reference's per-batch source-view selection
(train/train.py:203-221): one NS drawn per batch from `nviews`, per-object
view indices drawn without replacement, on a numpy generator, giving the
batch of `pixelnerf_tpu_torch.train.step`. `to_device` copies it to the
card from pinned memory, on the caller's thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["BatchLoader", "collate", "make_step_batch", "to_device"]


def collate(items: List[dict]) -> Dict[str, np.ndarray]:
    """Stack per-object dicts into batch arrays (keys present in all items)."""
    items = [it for it in items if it]
    keys = set(items[0])
    for it in items[1:]:
        keys &= set(it)
    out: Dict[str, np.ndarray] = {}
    for k in keys:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray) or np.isscalar(v0) or isinstance(v0, (int, float)):
            out[k] = np.stack([np.asarray(it[k]) for it in items])
        else:
            out[k] = [it[k] for it in items]  # e.g. paths
    return out


class BatchLoader:
    """Shuffled batching iterator over a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: bool = True,
        num_shards: int = 1,
        shard_id: int = 0,
        cache_images: bool = False,
    ):
        """:param num_shards/shard_id input sharding over processes: every
        process builds the loader with the same seed, so the shuffled epoch
        order is the same everywhere, and loads the disjoint interleaved
        slice `shard_id` of it.

        :param cache_images keep every fetched per-object dict in RAM with
        the float `images` array re-quantized to uint8, so epochs after the
        first skip image decode. Exact for straight u8 decodes (SRN);
        alpha-composited / area-resized images shift <= 1/255 per channel,
        the compact wire format's tolerance. Not for per-epoch augmentation
        (ColorJitterDataset): the cache would freeze the first epoch's
        jitter."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_id = shard_id
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[Dict[int, dict]] = {} if cache_images else None

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.num_shards > 1:
            # same permutation everywhere; disjoint interleaved slices
            usable = (len(idx) // self.num_shards) * self.num_shards
            idx = idx[:usable][self.shard_id :: self.num_shards]
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _get(self, i: int) -> dict:
        if self._cache is None:
            return self.dataset[i]
        item = self._cache.get(i)
        if item is None:
            item = dict(self.dataset[i])
            img = item.get("images")
            if isinstance(img, np.ndarray) and img.dtype == np.float32:
                # [-1, 1] float <-> uint8: exact inverse of the decoders'
                # img / 127.5 - 1 mapping
                item["images"] = np.rint(
                    np.clip((img + 1.0) * 127.5, 0.0, 255.0)
                ).astype(np.uint8)
                item["_images_u8"] = True
            self._cache[i] = item
        if item.get("_images_u8"):
            item = dict(item)
            del item["_images_u8"]
            # keep the raw u8 alongside the floats: the compact wire
            # format (make_step_batch compact_transfer) sends exactly
            # this array, skipping its f32 -> u8 re-quantize pass
            item["images_u8"] = item["images"]
            item["images"] = (
                item["images"].astype(np.float32) / 127.5 - 1.0
            )
        return item

    def _load(self, batch_idx: np.ndarray) -> Dict[str, np.ndarray]:
        return collate([self._get(int(i)) for i in batch_idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        if not self.prefetch:
            for b in batches:
                yield self._load(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = object()

        def worker():
            try:
                for b in batches:
                    q.put(self._load(b))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def make_step_batch(
    data: Dict[str, np.ndarray],
    rng: np.random.Generator,
    nviews: Sequence[int],
    use_bbox: bool = True,
    compact_transfer: bool = False,
) -> Dict[str, np.ndarray]:
    """Build the train-step batch: pick NS source views per object.

    Reference train.py:203-221: one NS drawn per batch from `nviews`; with
    NS == 1 a single randint per object, else choice without replacement.

    :param compact_transfer produce the compact batch: images quantized
        back to uint8 and source views referenced by `image_ord` indices
        instead of duplicated pixels; the step expands and gathers them on
        the device (train.step._prepare_batch), so the host-to-device copy
        moves about 5x fewer bytes. Exact for images that are straight u8
        decodes; alpha-composited or area-resized images can shift by up to
        1/255 per channel (CLI: --no_compact_transfer for the float batch).
    """
    images = data["images"]  # (SB, NV, H, W, 3) f32 in [-1, 1]
    SB, NV = images.shape[:2]
    curr_nviews = int(nviews[rng.integers(0, len(nviews))])
    if curr_nviews == 1:
        image_ord = rng.integers(0, NV, (SB, 1))
    else:
        image_ord = np.stack(
            [rng.choice(NV, curr_nviews, replace=False) for _ in range(SB)]
        )

    focal = np.asarray(data["focal"], dtype=np.float32)
    if focal.ndim == 1:
        focal = np.stack([focal, focal], axis=-1)  # (SB, 2)
    H, W = images.shape[2:4]
    if "c" in data:
        c = np.asarray(data["c"], dtype=np.float32)
        if c.ndim == 1:
            c = np.stack([c, c], axis=-1)
    else:
        c = np.tile(
            np.array([[W * 0.5, H * 0.5]], dtype=np.float32), (SB, 1)
        )

    if compact_transfer:
        if "images_u8" in data:  # cache-fed loader: already quantized
            images_u8 = np.asarray(data["images_u8"])
        else:
            u8 = np.clip((images.astype(np.float32) + 1.0) * 127.5, 0, 255)
            images_u8 = np.rint(u8).astype(np.uint8)
        batch = {
            "images_u8": images_u8,
            "image_ord": image_ord.astype(np.int32),
            "poses": data["poses"].astype(np.float32),
            "focal": focal,
            "c": c,
        }
    else:
        take = lambda arr: np.stack(
            [arr[b][image_ord[b]] for b in range(SB)]
        )
        batch = {
            "images": images.astype(np.float32),
            "poses": data["poses"].astype(np.float32),
            "focal": focal,
            "c": c,
            "src_images": take(images).astype(np.float32),
            "src_poses": take(data["poses"]).astype(np.float32),
        }
    if use_bbox and "bbox" in data:
        batch["bbox"] = data["bbox"].astype(np.float32)
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, "torch.Tensor"]:
    """The batch as tensors on `device`. For a CUDA device each array is
    copied into pinned host memory and then to the card without blocking
    the caller; the copies run on the current stream, ahead of the step
    that reads them."""
    import torch

    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
