"""encode_ms.view: milliseconds of `encode_views` a view, by CUDA events
around the call in the benchmark's loop (mean over the traced views).
Moves view_rays_per_s."""


def read(run):
    if not run.encode_ms:
        return None
    return sum(run.encode_ms) / len(run.encode_ms)
