"""Point sets for the scatter tests, as a train step hands them to a lookup.

A step's points are ray-major: consecutive points of a map are samples
along one ray, whose projections move a pixel or less from one sample to
the next (`models/pixelnerf.py:query`). `ray_uv` makes such runs, of
uneven lengths so that rays straddle the kernels' run and chunk
boundaries, some leaving the map (border clipping).
"""

import numpy as np


def ray_uv(rng, b, n, step, lengths=(5, 70)):
    """(b, n, 2) float32 normalized points: rays of `lengths` samples each,
    consecutive samples `step` apart, starting anywhere in [-1.2, 1.2]^2."""
    out = np.empty((b, n, 2), np.float32)
    i = 0
    while i < n:
        k = min(int(rng.integers(*lengths)), n - i)
        start = rng.uniform(-1.2, 1.2, (b, 1, 2))
        d = rng.normal(size=(b, 1, 2))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out[:, i : i + k] = start + d * step * np.arange(k)[None, :, None]
        i += k
    return out
