"""kernels_per_step.train: device operations (kernels, copies, sets) a step
launches, counted in the trace. Moves train_rays_per_s."""


def read(run):
    if run.trace is None or run.units == 0:
        return None
    n = sum(1 for o in run.trace.ops if o.span == "bench.step")
    return n / run.units if n else None
