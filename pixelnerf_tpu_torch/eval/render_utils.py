"""Eval-time full-image rendering in fixed-size chunks.

Counterpart of `pixelnerf_tpu/eval/render_utils.py`: every chunk is one
`render_rays` call at a fixed ray count (the last chunk padded by
repeating its last ray), with the fused field path turned on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pixelnerf_tpu_torch.render.renderer import RendererConfig, render_rays

__all__ = ["make_chunk_renderer", "render_full"]


def make_chunk_renderer(model, rcfg: RendererConfig):
    """render_chunk(enc, rays (1, chunk, 8), generator) -> outputs, on a
    copy of `model` that runs the fused gather+field kernel."""
    model = model.with_field_fusion()

    @torch.inference_mode()
    def render_chunk(enc, rays, generator):
        def query_fn(xyz, viewdirs, coarse):
            return model.query(enc, xyz, viewdirs, coarse)

        return render_rays(
            query_fn, rays, rcfg, generator=generator, want_weights=True,
            use_viewdirs=model.use_viewdirs, train=False,
        )

    return render_chunk


def render_full(
    model, enc, rays, rcfg: RendererConfig, chunk: int = 16384, seed: int = 0
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Render (B, 8) rays in chunks of `chunk` rays on the model's device.

    :return {'coarse': {'rgb' (B,3), 'depth' (B,), 'alpha' (B,)}, 'fine': ...}
        as tensors on the model's device
    """
    device = model.device
    if not torch.is_tensor(rays):
        rays = torch.from_numpy(np.array(rays, dtype=np.float32))
    rays = rays.to(device=device, dtype=torch.float32).reshape(-1, 8)
    B = rays.shape[0]
    chunk = min(chunk, max(B, 1))
    renderer = make_chunk_renderer(model, rcfg)
    pad = (-B) % chunk
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 8)], dim=0)

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    outs: Dict[str, Dict[str, list]] = {}
    for start in range(0, rays.shape[0], chunk):
        res = renderer(enc, rays[None, start : start + chunk], generator)
        for head, vals in res.items():
            dst = outs.setdefault(head, {"rgb": [], "depth": [], "alpha": []})
            dst["rgb"].append(vals["rgb"][0])
            dst["depth"].append(vals["depth"][0])
            dst["alpha"].append(vals["weights"][0].sum(-1))
    return {
        head: {k: torch.cat(v, dim=0)[:B] for k, v in vals.items()}
        for head, vals in outs.items()
    }
