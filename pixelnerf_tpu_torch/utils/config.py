"""Run-level argument + experiment-config system.

Counterpart of `pixelnerf_tpu/utils/config.py`, the reference's two-level
config design (src/util/args.py:9-112): argparse for run flags, HOCON
`.conf` trees for model/renderer/loss/train hyperparameters with file
inheritance, and an `expconf.conf` mapping experiment names to config
files / data dirs (args.py:87-97). The flags and defaults are the JAX
package's; `--debug_nans` turns on autograd's anomaly detection, which
raises at the backward of the operation that produced a NaN.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

from pixelnerf_tpu_torch.utils import hocon
from pixelnerf_tpu_torch.utils.hocon import ConfigTree

__all__ = ["parse_args", "load_conf", "ConfigTree", "PROJECT_ROOT"]

PROJECT_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def load_conf(path: str) -> ConfigTree:
    return hocon.load(path)


def parse_args(
    callback: Optional[Callable] = None,
    training: bool = False,
    default_conf: str = "conf/default_mv.conf",
    default_expname: str = "example",
    default_data_format: str = "dvr",
    default_num_epochs: int = 10000000,
    default_lr: float = 1e-4,
    default_gamma: float = 1.00,
    default_datadir: str = "data",
    default_ray_batch_size: int = 50000,
    argv=None,
) -> Tuple[argparse.Namespace, ConfigTree]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", "-c", type=str, default=None)
    parser.add_argument(
        "--resume", "-r", action="store_true", help="continue training"
    )
    parser.add_argument(
        "--mesh",
        type=str,
        default="",
        help="process mesh spec, e.g. 'data:2,rays:4': the training CLI's "
        "ranks over torch.distributed (world size = the product; empty = "
        "all ranks on rays); the eval CLIs run on one device",
    )
    parser.add_argument(
        "--name", "-n", type=str, default=default_expname, help="experiment name"
    )
    parser.add_argument(
        "--dataset_format",
        "-F",
        type=str,
        default=None,
        help="Dataset format, multi_obj | dvr | dvr_gen | dvr_dtu | srn | pollen",
    )
    parser.add_argument(
        "--exp_group_name",
        "-G",
        type=str,
        default=None,
        help="if we want to group some experiments together",
    )
    parser.add_argument("--logs_path", type=str, default="logs")
    parser.add_argument("--checkpoints_path", type=str, default="checkpoints")
    parser.add_argument("--visual_path", type=str, default="visuals")
    parser.add_argument("--epochs", type=int, default=default_num_epochs)
    parser.add_argument("--lr", type=float, default=default_lr)
    parser.add_argument(
        "--gamma", type=float, default=default_gamma, help="lr decay factor"
    )
    parser.add_argument("--datadir", "-D", type=str, default=None)
    parser.add_argument(
        "--ray_batch_size", "-R", type=int, default=default_ray_batch_size
    )
    parser.add_argument(
        "--image_size", type=int, nargs=2, default=None,
        metavar=("H", "W"),
        help="Area-resize dataset images to (H, W) with intrinsics "
        "rescale — e.g. 224 224 for ImageNet-geometry encoder finetuning "
        "(the reference's finetune_resnet.py:40-45 --image_size). On eval "
        "CLIs this must match the training resolution when the dataset's "
        "native size differs (the SRN loader defaults to 128x128 and "
        "UPSAMPLES smaller data, quadrupling render cost)",
    )
    parser.add_argument(
        "--debug_nans", action="store_true", default=False,
        help="torch.autograd.set_detect_anomaly: error out at the backward "
        "of the op that produced a NaN (the reference's train/train.py:29); "
        "slows execution, use for debugging only",
    )
    if callback is not None:
        parser = callback(parser)
    args = parser.parse_args(argv)

    if args.debug_nans:
        import torch

        torch.autograd.set_detect_anomaly(True)

    if args.exp_group_name is not None:
        args.logs_path = os.path.join(args.logs_path, args.exp_group_name)
        args.checkpoints_path = os.path.join(args.checkpoints_path, args.exp_group_name)
        args.visual_path = os.path.join(args.visual_path, args.exp_group_name)

    os.makedirs(os.path.join(args.checkpoints_path, args.name), exist_ok=True)
    os.makedirs(os.path.join(args.visual_path, args.name), exist_ok=True)

    expconf_path = os.path.join(PROJECT_ROOT, "expconf.conf")
    if os.path.exists(expconf_path):
        expconf = hocon.load(expconf_path)
    else:
        expconf = ConfigTree()

    if args.conf is None:
        args.conf = expconf.get_string("config." + args.name, default_conf)
    if args.datadir is None:
        args.datadir = expconf.get_string("datadir." + args.name, default_datadir)

    conf_path = args.conf
    if not os.path.isabs(conf_path) and not os.path.exists(conf_path):
        candidate = os.path.join(PROJECT_ROOT, conf_path)
        if os.path.exists(candidate):
            conf_path = candidate
    conf = hocon.load(conf_path)

    if args.dataset_format is None:
        args.dataset_format = conf.get_string("data.format", default_data_format)

    print("EXPERIMENT NAME:", args.name)
    if training:
        print("CONTINUE?", "yes" if args.resume else "no")
    print("* Config file:", args.conf)
    print("* Dataset format:", args.dataset_format)
    print("* Dataset location:", args.datadir)
    return args, conf
