"""Novel-view orbit video generation.

Counterpart of `pixelnerf_tpu/eval/gen_video.py` (the reference's
eval/gen_video.py): encodes chosen source views of one object, renders a
camera path (a NeRF-style 360 orbit, gen_video.py:157-172, or for DTU data
the IDR quaternion CubicSpline path, gen_video.py:120-156) and writes the
video (mp4 where imageio has an ffmpeg plugin, else a GIF of the same
basename, `utils/video.py`) and a strip of the source views. Runs on CUDA
unless `main` is given `device="cpu"`.

Run:
    python -m pixelnerf_tpu_torch.eval.gen_video -n srn600 -c conf/exp/srn600.conf \
        -D <srn600_dataset>/shapes --split test -S 0 -P "0 12" --num_views 40
"""

from __future__ import annotations

import os

import numpy as np


def extra_args(parser):
    parser.add_argument("--subset", "-S", type=int, default=0)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s), increasing order. -1 = random")
    parser.add_argument("--num_views", type=int, default=40)
    parser.add_argument("--elevation", type=float, default=-10.0)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--radius", type=float, default=0.0,
                        help="Camera orbit radius; 0 = (z_near + z_far) / 2")
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--seed", type=int, default=1234)
    return parser


def dtu_spline_poses(num_views: int) -> np.ndarray:
    """The IDR DTU camera path: a periodic CubicSpline through 5 key
    quaternions (reference gen_video.py:120-156)."""
    from scipy.interpolate import CubicSpline

    from pixelnerf_tpu_torch.utils.cameras import quat_to_rot

    t_in = np.array([0, 2, 3, 5, 6], dtype=np.float32)
    pose_quat = np.array(
        [
            [0.9698, 0.2121, 0.1203, -0.0039],
            [0.7020, 0.1578, 0.4525, 0.5268],
            [0.6766, 0.3176, 0.5179, 0.4161],
            [0.9085, 0.4020, 0.1139, -0.0025],
            [0.9698, 0.2121, 0.1203, -0.0039],
        ],
        dtype=np.float32,
    )
    n_inter = num_views // 5
    t_out = np.linspace(t_in[0], t_in[-1], n_inter * int(t_in[-1])).astype(np.float32)
    s_new = CubicSpline(t_in, np.full(5, 2.0, dtype=np.float32), bc_type="periodic")(t_out)
    q_new = CubicSpline(t_in, pose_quat, bc_type="periodic")(t_out)
    q_new = q_new / np.linalg.norm(q_new, axis=-1, keepdims=True)
    poses = []
    for q, scale in zip(q_new, s_new):
        rot = quat_to_rot(q[None])[0]
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = rot[:, 2] * scale
        poses.append(pose)
    return np.stack(poses)


def main(argv=None, device=None):
    """Returns (the video's path, the rendered frames (T, H, W, 3) uint8)."""
    import torch

    from pixelnerf_tpu_torch.eval.common import encode_views, load_model_and_dataset
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.utils import config as util_config
    from pixelnerf_tpu_torch.utils.cameras import pose_spherical
    from pixelnerf_tpu_torch.utils.rays import gen_rays
    from pixelnerf_tpu_torch.utils.video import write_video
    from pixelnerf_tpu_torch.utils.visualize import write_image

    args, conf = util_config.parse_args(extra_args, default_ray_batch_size=16384, argv=argv)
    args.resume = True

    model, dset, rcfg = load_model_and_dataset(args, conf, args.split, device)
    data = dset[args.subset]
    print("Data instance loaded:", data["path"])
    images, poses = data["images"], data["poses"]
    focal = np.asarray(data["focal"], dtype=np.float32)
    c = data.get("c")
    nv, h, w = images.shape[:3]
    if args.scale != 1.0:
        h, w = int(h * args.scale), int(w * args.scale)
        focal = focal * args.scale
        if c is not None:
            c = np.asarray(c) * args.scale

    z_near, z_far = dset.z_near, dset.z_far
    dtu_format = getattr(dset, "sub_format", None) == "dtu"
    if dtu_format:
        print("Using DTU camera trajectory")
        render_poses = dtu_spline_poses(args.num_views)
    else:
        print("Using default (360 loop) camera trajectory")
        radius = args.radius or (z_near + z_far) * 0.5
        render_poses = np.stack([
            pose_spherical(angle, args.elevation, radius)
            for angle in np.linspace(-180, 180, args.num_views + 1)[:-1]
        ])

    rng = np.random.default_rng(args.seed)
    source = np.array(list(map(int, args.source.split())))
    if len(source) == 1 and source[0] == -1:
        source = rng.integers(0, nv, 1)
    print("Source views:", source)

    enc = encode_views(model, images[source], poses[source], focal, c=c)
    all_rays = gen_rays(torch.from_numpy(render_poses), w, h, torch.from_numpy(focal), z_near,
                        z_far, c=None if c is None else torch.from_numpy(np.asarray(c, np.float32)))
    n_frames = len(render_poses)
    print("Rendering", n_frames * h * w, "rays")
    out = render_full(model, enc, all_rays.reshape(-1, 8), rcfg, chunk=args.ray_batch_size,
                      seed=args.seed)
    head = "fine" if "fine" in out else "coarse"
    frames = out[head]["rgb"].reshape(n_frames, h, w, 3).cpu().numpy()

    print("Writing video")
    vid_name = f"{args.split}{args.subset:04d}"
    if dtu_format:
        vid_name = "dtu_" + vid_name
    vid_path = os.path.join(args.visual_path, args.name, f"video_{vid_name}.mp4")
    viewimg_path = os.path.join(args.visual_path, args.name, f"video_{vid_name}_view.jpg")
    os.makedirs(os.path.dirname(vid_path), exist_ok=True)
    frames_u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    vid_path = write_video(vid_path, frames_u8, fps=args.fps)
    strip = np.concatenate(list(images[source] * 0.5 + 0.5), axis=1)
    write_image(viewimg_path, (strip * 255).astype(np.uint8))
    print("Wrote to", vid_path)
    return vid_path, frames_u8


if __name__ == "__main__":
    main()
