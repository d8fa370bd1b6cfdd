"""chunk_fill_pct.view: the share of the rays `render_full` rendered that
were asked for, 100 x rays / (rays + padded_rays), from the program's own
counters (`render_full.rays`, `render_full.padded_rays`) over every view
the run served; every view of a cell has one size, so each view reads the
same. The rest fill the last chunk. Moves view_rays_per_s."""


def read(run):
    from pixelnerf_tpu_torch.eval.render_utils import render_full

    rays, padded = getattr(render_full, "rays", 0), getattr(render_full, "padded_rays", 0)
    if run.kind != "view" or rays <= 0:
        return None
    return 100.0 * rays / (rays + padded)
