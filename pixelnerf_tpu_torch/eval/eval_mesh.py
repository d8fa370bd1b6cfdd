"""Per-object evaluation: mesh extraction and/or novel-view metrics.

Counterpart of `pixelnerf_tpu/eval/eval_mesh.py` (the fork's
eval/eval.py): per object, encode the source views and

(a) --mode mesh: query sigma on a grid (256^3 by default, 65,536-point
    chunks) through the fused gather+field kernel (the coarse head, zero
    view directions, as recon.py:38-41), extract the iso-surface on the
    host (`native/isosurface.cpp`) and write an STL (eval/eval.py:90-110);
(b) --mode nvs: render every non-source view, report PSNR/SSIM and write
    one PNG a view for `calc_metrics` (eval/eval.py:110-144);

with a crash-safe `finish.txt` log of the objects done (eval/eval.py:54).
Runs on CUDA unless `main` is given `device="cpu"`.

Run:
    python -m pixelnerf_tpu_torch.eval.eval_mesh -n srn600 -c conf/exp/srn600.conf \
        -D <srn600_dataset>/shapes --split test -P "0 12" --mode both
"""

from __future__ import annotations

import os

import numpy as np


def extra_args(parser):
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--source", "-P", type=str, default="0",
                        help="Source view(s) used to condition")
    parser.add_argument("--mode", type=str, default="mesh", help="mesh | nvs | both")
    parser.add_argument("--mesh_reso", type=int, default=256)
    parser.add_argument("--mesh_thresh", type=float, default=10.0)
    parser.add_argument("--mesh_chunk", type=int, default=65536)
    parser.add_argument("--mesh_bounds", type=float, default=1.0,
                        help="half-extent of the sigma grid's box (the reference hardcodes "
                        "[-1,1]^3, eval/eval.py:90-96)")
    parser.add_argument("--limit", type=int, default=0, help="0 = all objects")
    parser.add_argument("--output", "-O", type=str, default="eval_out")
    parser.add_argument("--overwrite", action="store_true")
    return parser


def main(argv=None, device=None):
    """Returns {object name: {"n_verts", "n_tris", "psnr", "ssim"}} for the
    objects this run evaluated (the keys of the modes it ran)."""
    import torch

    from pixelnerf_tpu_torch.eval.common import encode_views, load_model_and_dataset
    from pixelnerf_tpu_torch.eval.render_utils import make_chunk_renderer, render_full
    from pixelnerf_tpu_torch.native.isosurface import load_isosurface
    from pixelnerf_tpu_torch.utils import config as util_config
    from pixelnerf_tpu_torch.utils.metrics import psnr_np, ssim_np
    from pixelnerf_tpu_torch.utils.rays import gen_rays
    from pixelnerf_tpu_torch.utils.recon import eval_sigma_grid, save_stl
    from pixelnerf_tpu_torch.utils.visualize import write_png

    args, conf = util_config.parse_args(extra_args, default_ray_batch_size=16384, argv=argv)
    args.resume = True

    model, dset, rcfg = load_model_and_dataset(args, conf, args.split, device)
    source = np.array(list(map(int, args.source.split())))
    out_dir = os.path.join(args.output, args.name)
    os.makedirs(out_dir, exist_ok=True)
    finish_path = os.path.join(out_dir, "finish.txt")
    finished = set()
    if os.path.exists(finish_path) and not args.overwrite:
        with open(finish_path) as f:
            finished = {line.split()[0] for line in f if line.strip()}
    want_mesh = args.mode in ("mesh", "both")
    want_nvs = args.mode in ("nvs", "both")

    # the sigma query: the coarse head through the fused gather+field
    # kernel, with zero view directions (recon.py:38-41)
    sigma_model = model.with_field_fusion()
    renderer = make_chunk_renderer(model, rcfg) if want_nvs else None
    extract = load_isosurface() if want_mesh else None

    def sigma_chunk(enc, pts):
        xyz = pts[None]
        vd = torch.zeros_like(xyz) if model.use_viewdirs else None
        with torch.inference_mode():
            return sigma_model.query(enc, xyz, vd, True)[0, :, 3]

    n_objs = len(dset) if args.limit <= 0 else min(args.limit, len(dset))
    total_psnr = total_ssim = 0.0
    metric_cnt = 0
    results = {}
    with open(finish_path, "a") as finish_file:
        for obj_idx in range(n_objs):
            data = dset[obj_idx]
            if "images" not in data:
                continue
            obj_name = os.path.basename(data["path"])
            if obj_name in finished:
                continue
            images, poses = data["images"], data["poses"]
            focal = np.asarray(data["focal"], dtype=np.float32)
            c = data.get("c")
            nv, h, w = images.shape[:3]
            enc = encode_views(model, images[source], poses[source], focal, c=c)
            res = results[obj_name] = {}

            if want_mesh:
                half = float(args.mesh_bounds)
                vol = eval_sigma_grid(lambda pts: sigma_chunk(enc, pts), (args.mesh_reso,) * 3,
                                      c1=(-half,) * 3, c2=(half,) * 3,
                                      eval_batch_size=args.mesh_chunk, device=model.device)
                verts, tris = extract(vol, float(args.mesh_thresh))
                verts = verts * (2.0 * half / (args.mesh_reso - 1)) - half
                stl_path = os.path.join(out_dir, f"{obj_name}.stl")
                save_stl(verts, tris, stl_path)
                res.update(n_verts=len(verts), n_tris=len(tris))
                print(f"{obj_name}: {len(verts)} verts {len(tris)} tris -> {stl_path}")

            psnr_v = ssim_v = 0.0
            if want_nvs:
                novel = [v for v in range(nv) if v not in set(source.tolist())]
                rays = gen_rays(torch.from_numpy(poses[novel]), w, h, torch.from_numpy(focal),
                                dset.z_near, dset.z_far,
                                c=None if c is None else torch.from_numpy(np.asarray(c, np.float32)))
                out = render_full(model, enc, rays.reshape(-1, 8), rcfg, chunk=args.ray_batch_size,
                                  seed=obj_idx, renderer=renderer)
                head = "fine" if "fine" in out else "coarse"
                preds = out[head]["rgb"].reshape(len(novel), h, w, 3).cpu().numpy()
                gts = images[novel] * 0.5 + 0.5
                psnr_v = float(np.mean([psnr_np(preds[i], gts[i]) for i in range(len(novel))]))
                ssim_v = float(np.mean([ssim_np(preds[i], gts[i]) for i in range(len(novel))]))
                total_psnr += psnr_v
                total_ssim += ssim_v
                metric_cnt += 1
                img_dir = os.path.join(out_dir, obj_name)
                os.makedirs(img_dir, exist_ok=True)
                for i, v in enumerate(novel):
                    write_png(os.path.join(img_dir, f"{v:06d}.png"),
                              (np.clip(preds[i], 0, 1) * 255).astype(np.uint8))
                res.update(psnr=psnr_v, ssim=ssim_v)
                print(f"PSNR: {psnr_v:.2f}, SSIM: {ssim_v:.4f}", flush=True)

            finish_file.write(f"{obj_name} {psnr_v:.2f} {ssim_v:.4f} 1\n")
            finish_file.flush()

    if metric_cnt:
        print(f"TOTAL: psnr {total_psnr / metric_cnt:.3f} ssim {total_ssim / metric_cnt:.4f} "
              f"over {metric_cnt} objects")
    return results


if __name__ == "__main__":
    main()
