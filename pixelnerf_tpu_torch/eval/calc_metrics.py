"""Metrics over rendered images (map, then reduce).

Counterpart of `pixelnerf_tpu/eval/calc_metrics.py` (the reference's
eval/calc_metrics.py): per object (map), PSNR and SSIM of the rendered
PNGs (`eval_mesh --mode nvs`) against the dataset's images, with the
source-view exclusions and the DTU bad-view list (calc_metrics.py:142-145),
into `<output>/<object>/metrics.txt`; then (reduce) the means per category
and in total into `all_metrics.txt` (calc_metrics.py:257-340). LPIPS (VGG,
`utils/lpips.py`) runs on the device where its weights are on disk;
without them it is NaN with a warning, as the JAX CLI gives it, and the
means leave it out. PSNR and SSIM run on the host; the GT images are
resized on the CPU where their size differs from the renders'.

Run:
    python -m pixelnerf_tpu_torch.eval.calc_metrics -D <srn600_dataset>/shapes/test \
        -O eval_out/srn600 -F srn
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import warnings

import numpy as np

DTU_BAD_VIEWS = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]


def build_parser():
    parser = argparse.ArgumentParser(description="Calculate PSNR/SSIM(/LPIPS) for rendered images.")
    parser.add_argument("--datadir", "-D", type=str, required=True)
    parser.add_argument("--output", "-O", type=str, default="eval",
                        help="Root path of rendered output (from eval_mesh --mode nvs)")
    parser.add_argument("--dataset_format", "-F", type=str, default="dvr")
    parser.add_argument("--list_name", type=str, default="softras_test")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--exclude_dtu_bad", action="store_true")
    parser.add_argument("--multicat", action="store_true",
                        help="Prepend category id to object id (multi-category models)")
    parser.add_argument("--viewlist", "-L", type=str, default="",
                        help="Source-view list file; excludes those views from evaluation")
    parser.add_argument("--eval_view_list", type=str, default=None)
    parser.add_argument("--primary", "-P", type=str, default="", help="Views to exclude")
    parser.add_argument("--reduce_only", "-R", action="store_true")
    parser.add_argument("--metadata", type=str, default="metadata.yaml")
    return parser


def _gt_image_dirs(args):
    if args.dataset_format == "dvr":
        img_dir_name = "image"
    elif args.dataset_format == "srn":
        img_dir_name = "rgb"
    else:
        warnings.warn("using flat image layout for format " + args.dataset_format)
        img_dir_name = ""
    dirs = {}
    if args.multicat:
        for cat_dir in sorted(glob.glob(osp.join(args.datadir, "*"))):
            if not osp.isdir(cat_dir):
                continue
            cat = osp.basename(cat_dir)
            list_path = osp.join(cat_dir, args.list_name + ".lst")
            if osp.exists(list_path):
                with open(list_path) as f:
                    objs = [x.strip() for x in f if x.strip()]
            else:
                objs = sorted(osp.basename(d) for d in glob.glob(osp.join(cat_dir, "*"))
                              if osp.isdir(d))
            for obj in objs:
                dirs[f"{cat}_{obj}"] = osp.join(cat_dir, obj, img_dir_name)
    else:
        for d in sorted(glob.glob(osp.join(args.datadir, "*"))):
            if osp.isdir(d):
                dirs[osp.basename(d)] = osp.join(d, img_dir_name)
    return dirs


def _load_exclusions(args, obj_name):
    exclude = set()
    if args.primary:
        exclude |= {int(x) for x in args.primary.split()}
    if args.exclude_dtu_bad:
        exclude |= set(DTU_BAD_VIEWS)
    if args.viewlist and osp.exists(args.viewlist):
        with open(args.viewlist) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] in obj_name:
                    exclude |= {int(x) for x in parts[1:]}
    return exclude


def _resize_gt(gt: np.ndarray, hw) -> np.ndarray:
    """GT brought to the renders' size: area down, bilinear up."""
    import torch

    from pixelnerf_tpu_torch.data.common import resize_area_np
    from pixelnerf_tpu_torch.ops.interpolate import resize_bilinear

    warnings.warn(f"GT size {gt.shape[:2]} != render size {tuple(hw)}; resizing GT")
    if gt.shape[0] > hw[0]:
        return resize_area_np(gt[None], hw)[0]
    return resize_bilinear(torch.from_numpy(gt[None]), tuple(hw))[0].numpy()


def run_map(args, lpips_fn=None):
    from pixelnerf_tpu_torch.utils.metrics import psnr_np, ssim_np
    from pixelnerf_tpu_torch.utils.visualize import read_image

    for obj_name, gt_dir in _gt_image_dirs(args).items():
        out_dir = osp.join(args.output, obj_name)
        if not osp.isdir(out_dir):
            continue
        metrics_path = osp.join(out_dir, "metrics.txt")
        if osp.exists(metrics_path) and not args.overwrite:
            continue
        exclude = _load_exclusions(args, obj_name)
        gt_paths = (sorted(glob.glob(osp.join(gt_dir, "*.png")))
                    + sorted(glob.glob(osp.join(gt_dir, "*.jpg"))))
        psnr_avg = ssim_avg = lpips_avg = 0.0
        num = 0
        for render_path in sorted(glob.glob(osp.join(out_dir, "*.png"))):
            view_id = int(osp.splitext(osp.basename(render_path))[0])
            if view_id in exclude or view_id >= len(gt_paths):
                continue
            pred = read_image(render_path).astype(np.float32) / 255.0
            gt = read_image(gt_paths[view_id]).astype(np.float32)[..., :3] / 255.0
            if gt.shape[:2] != pred.shape[:2]:
                gt = _resize_gt(gt, pred.shape[:2])
            psnr_avg += psnr_np(pred, gt)
            ssim_avg += ssim_np(pred, gt, data_range=1.0)
            if lpips_fn is not None:
                lpips_avg += lpips_fn(np.transpose(pred * 2 - 1, (2, 0, 1))[None],
                                      np.transpose(gt * 2 - 1, (2, 0, 1))[None])
            num += 1
        if num == 0:
            continue
        psnr_avg /= num
        ssim_avg /= num
        lpips_v = lpips_avg / num if lpips_fn is not None else float("nan")
        with open(metrics_path, "w") as f:
            f.write(f"psnr {psnr_avg}\nssim {ssim_avg}\nlpips {lpips_v}")
        print(obj_name, "psnr", psnr_avg, "ssim", ssim_avg)


def run_reduce(args) -> dict:
    """Write all_metrics.txt; returns {category or "total": {"psnr",
    "ssim", "lpips", "n"}}."""
    per_cat, all_vals = {}, []
    for mf in sorted(glob.glob(osp.join(args.output, "*", "metrics.txt"))):
        obj_name = osp.basename(osp.dirname(mf))
        cat = obj_name.split("_")[0] if args.multicat else "all"
        vals = {}
        with open(mf) as f:
            for line in f:
                k, v = line.split()
                vals[k] = float(v)
        per_cat.setdefault(cat, []).append(vals)
        all_vals.append(vals)

    def avg(vals_list, key):
        xs = [v[key] for v in vals_list if not np.isnan(v.get(key, np.nan))]
        return float(np.mean(xs)) if xs else float("nan")

    summary, lines = {}, []
    for cat, vals in [*sorted(per_cat.items()), ("total", all_vals)]:
        summary[cat] = {k: avg(vals, k) for k in ("psnr", "ssim", "lpips")}
        summary[cat]["n"] = len(vals)
        lines.append(f"{cat} psnr {summary[cat]['psnr']:.6f} ssim {summary[cat]['ssim']:.6f} "
                     f"lpips {summary[cat]['lpips']:.6f} n {len(vals)}")
    out_path = osp.join(args.output, "all_metrics.txt")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print("Wrote", out_path)
    return summary


def main(argv=None, device=None):
    """Returns `run_reduce`'s summary. PSNR and SSIM run on the host; LPIPS,
    where its weights are on disk (`utils/metrics.lpips_fn`), on `device`
    (CUDA unless named), else it is NaN."""
    from pixelnerf_tpu_torch.utils.metrics import lpips_fn as make_lpips

    args = build_parser().parse_args(argv)
    if not args.reduce_only:
        lp = make_lpips("vgg", device=device)
        if lp is None:
            warnings.warn("lpips weights absent; reporting NaN for LPIPS")
        run_map(args, lpips_fn=lp)
    return run_reduce(args)


if __name__ == "__main__":
    main()
