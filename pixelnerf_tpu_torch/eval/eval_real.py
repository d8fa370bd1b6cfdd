"""Single real-image demo: encode one normalized image, render an orbit.

Counterpart of `pixelnerf_tpu/eval/eval_real.py` (the reference's
eval/eval_real.py:100-171): a dummy camera at `--radius` on +z,
Blender-coordinate spherical orbit poses, a chunked render of each frame,
per-frame PNGs and an mp4 (or GIF, `utils/video.py`). Inputs are
`*_normalize.png` images (the JAX package's `eval/preproc.py` makes them;
it is not ported). Runs on CUDA unless `main` is given `device="cpu"`.

Run:
    python -m pixelnerf_tpu_torch.eval.eval_real -n srn600 -c conf/exp/srn600.conf \
        --input ./input --output ./output --size 128
"""

from __future__ import annotations

import os

import numpy as np


def extra_args(parser):
    parser.add_argument("--input", "-I", type=str, default="input")
    parser.add_argument("--output", "-O", type=str, default="output")
    parser.add_argument("--size", type=int, default=128, help="Input image size")
    parser.add_argument("--out_size", type=str, default="128")
    parser.add_argument("--focal", type=float, default=131.25)
    parser.add_argument("--radius", type=float, default=1.3)
    parser.add_argument("--z_near", type=float, default=0.8)
    parser.add_argument("--z_far", type=float, default=1.8)
    parser.add_argument("--elevation", type=float, default=0.0)
    parser.add_argument("--num_views", type=int, default=24)
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument("--gif", action="store_true")
    parser.add_argument("--no_vid", action="store_true")
    return parser


def main(argv=None, device=None):
    """Returns {input path: frames (num_views, H, W, 3) uint8}."""
    import torch

    from pixelnerf_tpu_torch.data.common import resize_area_np
    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.eval.render_utils import make_chunk_renderer, render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt_io
    from pixelnerf_tpu_torch.utils import config as util_config
    from pixelnerf_tpu_torch.utils.cameras import coord_from_blender, pose_spherical
    from pixelnerf_tpu_torch.utils.rays import gen_rays
    from pixelnerf_tpu_torch.utils.video import write_video
    from pixelnerf_tpu_torch.utils.visualize import read_image, write_png

    args, conf = util_config.parse_args(extra_args, default_ray_batch_size=16384, argv=argv)
    args.resume = True

    in_sz = args.size
    sz = list(map(int, args.out_size.split()))
    if len(sz) == 1:
        h = w = sz[0]
    else:
        w, h = sz
    # --focal is at the input (encoded) resolution, like the reference's
    # absolute focal (eval/eval_real.py:44,86): the render's rays scale it
    # to the output size, the encoder keeps it, since its projection lands
    # in the in_sz feature map
    focal_render = args.focal * w / in_sz
    focal_encode = args.focal

    model = make_model(conf["model"], device=resolve_device(device))
    ckpt_io.load_model_weights(model, args.checkpoints_path, args.name, resume=True)
    rcfg = RendererConfig.from_conf(conf["renderer"])
    renderer = make_chunk_renderer(model, rcfg)

    from_blender = coord_from_blender()
    render_poses = np.stack([
        from_blender @ pose_spherical(angle, args.elevation, args.radius)
        for angle in np.linspace(-180, 180, args.num_views + 1)[:-1]
    ])
    all_rays = gen_rays(torch.from_numpy(render_poses), w, h, torch.tensor([focal_render]),
                        args.z_near, args.z_far).reshape(-1, 8)

    inputs_all = os.listdir(args.input) if os.path.isdir(args.input) else []
    inputs = [os.path.join(args.input, x) for x in sorted(inputs_all) if x.endswith("_normalize.png")]
    os.makedirs(args.output, exist_ok=True)
    if not inputs:
        if not inputs_all:
            print("No input images found, please place an image into ./input")
        else:
            print("No processed input images found, did you run "
                  "`python -m pixelnerf_tpu.eval.preproc`?")
        raise SystemExit(1)

    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[2, -1] = args.radius
    print("SET DUMMY CAMERA\n", cam_pose)

    results = {}
    for i, image_path in enumerate(inputs):
        print("IMAGE", i + 1, "of", len(inputs), "@", image_path)
        img = read_image(image_path).astype(np.float32)[..., :3] / 255.0
        if img.shape[0] != in_sz or img.shape[1] != in_sz:
            img = resize_area_np(img[None], (in_sz, in_sz))[0]
        img = img * 2.0 - 1.0
        dev = model.device
        with torch.inference_mode():
            enc = model.encode(torch.from_numpy(img)[None, None].to(dev),
                               torch.from_numpy(cam_pose)[None, None].to(dev),
                               torch.tensor([focal_encode]))
        print("Rendering", args.num_views * h * w, "rays")
        out = render_full(model, enc, all_rays, rcfg, chunk=args.ray_batch_size, seed=i,
                          renderer=renderer)
        head = "fine" if "fine" in out else "coarse"
        frames = (np.clip(out[head]["rgb"].reshape(args.num_views, h, w, 3).cpu().numpy(), 0, 1)
                  * 255).astype(np.uint8)
        im_name = os.path.basename(os.path.splitext(image_path)[0])
        frames_dir = os.path.join(args.output, im_name + "_frames")
        os.makedirs(frames_dir, exist_ok=True)
        for k in range(args.num_views):
            write_png(os.path.join(frames_dir, f"{k:04d}.png"), frames[k])
        if not args.no_vid:
            ext = ".gif" if args.gif else ".mp4"
            vid_path = write_video(os.path.join(args.output, im_name + "_vid" + ext), frames,
                                   fps=args.fps)
            print("Wrote to", vid_path)
        results[image_path] = frames
    return results


if __name__ == "__main__":
    main()
