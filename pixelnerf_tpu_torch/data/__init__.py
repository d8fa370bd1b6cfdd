"""Dataset factory: counterpart of `pixelnerf_tpu/data/__init__.py`
(reference: src/data/__init__.py:10-72)."""

from __future__ import annotations

from pixelnerf_tpu_torch.data.augment import ColorJitterDataset  # noqa: F401
from pixelnerf_tpu_torch.data.dvr import DVRDataset  # noqa: F401
from pixelnerf_tpu_torch.data.loader import BatchLoader, collate, make_step_batch, to_device  # noqa: F401
from pixelnerf_tpu_torch.data.multi_obj import MultiObjectDataset  # noqa: F401
from pixelnerf_tpu_torch.data.srn import SRNDataset  # noqa: F401

__all__ = [
    "get_split_dataset",
    "SRNDataset",
    "DVRDataset",
    "MultiObjectDataset",
    "ColorJitterDataset",
    "BatchLoader",
    "collate",
    "make_step_batch",
    "to_device",
]


def get_split_dataset(dataset_type, datadir, want_split="all", training=True, **kwargs):
    """Map a format string to dataset class + flags.

    Formats: srn | pollen | multi_obj | dvr | dvr_gen | dvr_dtu
    (reference src/data/__init__.py:22-49; 'pollen' additionally enables the
    fork's near_far.txt override + lindisp from orgSRNDataset.py:94-105,
    which the reference factory never wired up).
    """
    dset_class, train_aug = None, None
    flags, train_aug_flags = {}, {}

    if dataset_type == "srn":
        dset_class = SRNDataset
    elif dataset_type == "pollen":
        dset_class = SRNDataset
        flags["use_near_far"] = True
        flags["lindisp"] = True
    elif dataset_type == "multi_obj":
        dset_class = MultiObjectDataset
    elif dataset_type.startswith("dvr"):
        dset_class = DVRDataset
        if dataset_type == "dvr_gen":
            flags["list_prefix"] = "gen_"
        elif dataset_type == "dvr_dtu":
            flags["list_prefix"] = "new_"
            if training:
                flags["max_imgs"] = 49
            flags["sub_format"] = "dtu"
            flags["scale_focal"] = False
            flags["z_near"] = 0.1
            flags["z_far"] = 5.0
            train_aug = ColorJitterDataset
            train_aug_flags = {"extra_inherit_attrs": ["sub_format"]}
    else:
        raise NotImplementedError("Unsupported dataset type", dataset_type)

    want_train = want_split not in ("val", "test")
    want_val = want_split not in ("train", "test")
    want_test = want_split not in ("train", "val")

    train_set = val_set = test_set = None
    if want_train:
        train_set = dset_class(datadir, stage="train", **flags, **kwargs)
        if train_aug is not None:
            train_set = train_aug(train_set, **train_aug_flags)
    if want_val:
        val_set = dset_class(datadir, stage="val", **flags, **kwargs)
    if want_test:
        test_set = dset_class(datadir, stage="test", **flags, **kwargs)

    if want_split == "train":
        return train_set
    if want_split == "val":
        return val_set
    if want_split == "test":
        return test_set
    return train_set, val_set, test_set
