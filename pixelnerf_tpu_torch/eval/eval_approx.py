"""Approximate PSNR + SSIM evaluation (one random target view per object).

Counterpart of `pixelnerf_tpu/eval/eval_approx.py` (the reference's
eval/eval_approx.py): quick development-time metrics from a seeded random
target view per object, rendered with the fine head (or, with --coarse,
the coarse head at boosted sample counts), averaging skimage-compatible
PSNR and SSIM. Runs on CUDA unless `main` is given `device="cpu"`.

Run:
    python -m pixelnerf_tpu_torch.eval.eval_approx -n srn600 -c conf/exp/srn600.conf \
        -D <srn600_dataset>/shapes --split test -P "0 12" --seed 1234
"""

from __future__ import annotations

import numpy as np


def extra_args(parser):
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s). -1 = random 1 view per object")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--limit", type=int, default=0,
                        help="evaluate only the first N objects (0 = all)")
    parser.add_argument("--coarse", action="store_true", help="Use coarse net as fine")
    return parser


def main(argv=None, device=None):
    """Returns (mean PSNR, mean SSIM) over the objects evaluated."""
    import torch

    from pixelnerf_tpu_torch.eval.common import encode_views, load_model_and_dataset, without_fine
    from pixelnerf_tpu_torch.eval.render_utils import make_chunk_renderer, render_full
    from pixelnerf_tpu_torch.utils import config as util_config
    from pixelnerf_tpu_torch.utils.metrics import psnr_np, ssim_np
    from pixelnerf_tpu_torch.utils.rays import gen_rays

    args, conf = util_config.parse_args(extra_args, default_ray_batch_size=16384, argv=argv)
    args.resume = True

    model, dset, rcfg = load_model_and_dataset(args, conf, args.split, device)
    if rcfg.n_coarse < 64:
        rcfg = rcfg.replace(n_coarse=64)
    if args.coarse:
        # the reference boosts sampling and routes fine -> coarse net
        # (eval_approx.py:64-80): the importance samples are still drawn
        rcfg = rcfg.replace(n_coarse=64, n_fine=128)
        model = without_fine(model)
    renderer = make_chunk_renderer(model, rcfg)

    rng = np.random.default_rng(args.seed)
    source = np.array(list(map(int, args.source.split())))
    random_source = len(source) == 1 and source[0] == -1

    total_psnr = total_ssim = 0.0
    cnt = 0
    n_objs = len(dset) if args.limit <= 0 else min(args.limit, len(dset))
    for obj_idx in range(n_objs):
        data = dset[obj_idx]
        if "images" not in data:
            continue
        images, poses = data["images"], data["poses"]
        focal = np.asarray(data["focal"], dtype=np.float32)
        c = data.get("c")
        nv, h, w = images.shape[:3]
        views_src = rng.integers(0, nv, 1) if random_source else source
        target = int(rng.integers(0, nv))

        enc = encode_views(model, images[views_src], poses[views_src], focal, c=c)
        rays = gen_rays(torch.from_numpy(poses[target : target + 1]), w, h,
                        torch.from_numpy(focal), dset.z_near, dset.z_far,
                        c=None if c is None else torch.from_numpy(np.asarray(c, np.float32)))
        out = render_full(model, enc, rays.reshape(-1, 8), rcfg, chunk=args.ray_batch_size,
                          seed=args.seed + obj_idx, renderer=renderer)
        head = "fine" if "fine" in out else "coarse"
        pred = out[head]["rgb"].reshape(h, w, 3).cpu().numpy()
        gt = images[target] * 0.5 + 0.5
        total_psnr += psnr_np(pred, gt)
        total_ssim += ssim_np(pred, gt, data_range=1.0)
        cnt += 1
        if obj_idx % 10 == 0:
            print("curr psnr", total_psnr / cnt, "ssim", total_ssim / cnt)

    print("final psnr", total_psnr / cnt, "ssim", total_ssim / cnt)
    return total_psnr / cnt, total_ssim / cnt


if __name__ == "__main__":
    main()
