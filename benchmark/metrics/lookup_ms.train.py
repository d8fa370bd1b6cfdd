"""lookup_ms.train: device milliseconds a step in the lookup's kernels (the
pyramid or bilerp gather and scatter, or PyTorch's grid sampler where a
map is too large for them). Moves train_rays_per_s."""


def read(run):
    if run.trace is None or run.units == 0:
        return None
    spent = run.trace.seconds({"lookup kernels"}, span="bench.step")
    return 1e3 * spent / run.units if spent > 0 else None
