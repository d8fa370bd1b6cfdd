"""Port parity: the port's datasets, batch loader and step batches against
the JAX package's, on tests/fixtures.py's synthetic datasets.

Both sides are numpy code on the host, drawing from numpy generators with
the same seeds, so every array must be equal bit for bit. Both sides read
the fixtures' PNGs with the repository's native decoder (native/
imagecodec.cpp), each through its own build; the port's Pillow fallback,
which runs where the library cannot be built, is held to the same pixels.
"""

import numpy as np
import pytest
import torch

import pixelnerf_tpu.data as jdata
import pixelnerf_tpu_torch.data as tdata
from pixelnerf_tpu_torch.data import common as tcommon
from pixelnerf_tpu_torch.native import imagecodec
from tests.fixtures import make_dvr_dataset, make_multi_obj_dataset, make_srn_dataset

FORMATS = ("srn", "pollen", "multi_obj", "dvr", "dvr_gen", "dvr_dtu")


@pytest.fixture(scope="module")
def datadirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    srn = make_srn_dataset(root, name="balls", n_objs=5, nv=4, H=16)
    return {
        "srn": srn,
        "pollen": make_srn_dataset(root, name="pollen", n_objs=2, nv=3, H=16,
                                   near_far=True, rgba=True),
        "multi_obj": make_multi_obj_dataset(root, n_scenes=2, nv=3, H=16),
        "dvr": make_dvr_dataset(root + "/shapenet", n_objs=2, nv=4, H=16),
        "dvr_gen": make_dvr_dataset(root + "/gen", n_objs=2, nv=3, H=16, list_prefix="gen_"),
        "dvr_dtu": make_dvr_dataset(root + "/dtu", n_objs=2, nv=5, H=16, list_prefix="new_",
                                    with_masks=False),
    }


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or np.isscalar(w):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k
        else:
            assert g == w, k


def test_native_decoder_builds_here():
    assert imagecodec.available(), imagecodec.decoder()
    assert imagecodec.decoder() == "native"


@pytest.mark.parametrize("fmt", FORMATS)
def test_split_datasets_match_jax(datadirs, fmt):
    """get_split_dataset: the same classes, flags and bounds, and every
    item of every split equal (the dvr_dtu train set through ColorJitter,
    whose draws follow its generator item by item)."""
    want = jdata.get_split_dataset(fmt, datadirs[fmt])
    got = tdata.get_split_dataset(fmt, datadirs[fmt])
    for w, g in zip(want, got):
        assert type(g).__name__ == type(w).__name__
        assert (g.z_near, g.z_far, g.lindisp, len(g)) == (w.z_near, w.z_far, w.lindisp, len(w))
        for i in range(len(w)):
            _assert_items_equal(g[i], w[i])
    if fmt == "dvr_dtu":
        assert isinstance(got[0], tdata.ColorJitterDataset)
        assert got[0].sub_format == "dtu"
        # a second pass draws new jitter on both sides
        _assert_items_equal(got[0][0], want[0][0])


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_split_selection_matches_jax(datadirs, split):
    got = tdata.get_split_dataset("srn", datadirs["srn"], want_split=split)
    want = jdata.get_split_dataset("srn", datadirs["srn"], want_split=split)
    assert got.stage == want.stage == split and len(got) == len(want)


def test_srn_resize_matches_jax(datadirs):
    """Area resize with the intrinsics and bboxes rescaled."""
    got = tdata.SRNDataset(datadirs["srn"], image_size=(8, 8))[1]
    want = jdata.SRNDataset(datadirs["srn"], image_size=(8, 8))[1]
    assert got["images"].shape == (4, 8, 8, 3)
    _assert_items_equal(got, want)


def test_dvr_view_subset_matches_jax(datadirs):
    """max_imgs draws each object's view subset from the dataset's own
    generator: the same subsets, item after item."""
    kw = dict(list_prefix="new_", sub_format="dtu", scale_focal=False, max_imgs=3,
              z_near=0.1, z_far=5.0)
    got = tdata.DVRDataset(datadirs["dvr_dtu"], **kw)
    want = jdata.DVRDataset(datadirs["dvr_dtu"], **kw)
    for i in (0, 1, 0):
        g = got[i]
        _assert_items_equal(g, want[i])
        assert g["images"].shape[0] == 3


def test_multi_obj_resize_matches_jax(datadirs):
    got = tdata.MultiObjectDataset(datadirs["multi_obj"], image_size=(8, 12))[0]
    want = jdata.MultiObjectDataset(datadirs["multi_obj"], image_size=(8, 12))[0]
    _assert_items_equal(got, want)


def test_pillow_fallback_reads_the_same_pixels(datadirs, monkeypatch):
    """Where the native library is missing (decode_batch gives None) the
    port reads with Pillow: the same arrays, RGBA (pollen) included."""
    for fmt in ("srn", "pollen", "dvr"):
        native = tdata.get_split_dataset(fmt, datadirs[fmt], want_split="train")[0]
        with monkeypatch.context() as m:
            m.setattr(imagecodec, "decode_batch", lambda paths, num_threads=0: None)
            fallback = tdata.get_split_dataset(fmt, datadirs[fmt], want_split="train")[0]
        _assert_items_equal(fallback, native)
    path = f"{datadirs['pollen']}/pollen_train/obj000/rgb/000000.png"
    with monkeypatch.context() as m:
        m.setattr(imagecodec, "decode_batch", lambda paths, num_threads=0: None)
        rgba = tcommon.load_image(path)
    assert rgba.shape == (16, 16, 4) and np.array_equal(rgba, tcommon.load_image(path))


def _epochs(loader, n=2):
    return [b for _ in range(n) for b in loader]


@pytest.mark.parametrize("shards", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("prefetch", [True, False])
def test_batch_loader_order_matches_jax(datadirs, shards, prefetch):
    """The same shuffled order epoch after epoch, and the same disjoint
    slice per shard."""
    num_shards, shard_id = shards
    kw = dict(shuffle=True, seed=0, num_shards=num_shards, shard_id=shard_id, prefetch=prefetch)
    got = tdata.BatchLoader(tdata.SRNDataset(datadirs["srn"]), 2, **kw)
    want = jdata.BatchLoader(jdata.SRNDataset(datadirs["srn"]), 2, **kw)
    assert len(got) == len(want)
    gb, wb = _epochs(got), _epochs(want)
    assert len(gb) == len(wb) > 0
    for g, w in zip(gb, wb):
        _assert_items_equal(g, w)


def test_batch_loader_image_cache_matches_jax(datadirs):
    """cache_images: from the second epoch on, the u8 cache and the floats
    rebuilt from it, on both sides alike."""
    kw = dict(shuffle=True, seed=3, cache_images=True)
    gb = _epochs(tdata.BatchLoader(tdata.SRNDataset(datadirs["srn"]), 3, **kw), 3)
    wb = _epochs(jdata.BatchLoader(jdata.SRNDataset(datadirs["srn"]), 3, **kw), 3)
    assert any("images_u8" in b for b in gb)
    for g, w in zip(gb, wb):
        _assert_items_equal(g, w)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("nviews", [[2], [1], [1, 2]])
@pytest.mark.parametrize("cache", [False, True])
def test_make_step_batch_matches_jax(datadirs, compact, nviews, cache):
    """The step batch over several batches: the same NS, source views,
    bboxes and compact bytes from the same generator."""
    got, want = [], []
    for data, out, seed in ((tdata, got, 42), (jdata, want, 42)):
        rng = np.random.default_rng(seed)
        loader = data.BatchLoader(data.SRNDataset(datadirs["srn"]), 2, seed=0,
                                  cache_images=cache)
        for b in _epochs(loader):
            out.append(data.make_step_batch(b, rng, nviews, use_bbox=True,
                                            compact_transfer=compact))
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
    ns = {b["image_ord" if compact else "src_images"].shape[1] for b in got}
    assert ns <= set(nviews)


def test_to_device_on_the_cpu(datadirs):
    b = next(iter(tdata.BatchLoader(tdata.SRNDataset(datadirs["srn"]), 2, prefetch=False)))
    batch = tdata.make_step_batch(b, np.random.default_rng(0), [2], compact_transfer=True)
    dev = tdata.to_device(batch, "cpu")
    assert set(dev) == set(batch)
    for k, v in batch.items():
        assert dev[k].device.type == "cpu" and np.array_equal(dev[k].numpy(), v)
    assert dev["images_u8"].dtype == torch.uint8
