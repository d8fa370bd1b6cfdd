"""renderer_ms.view: device milliseconds a view launched by `render_full`
outside the field and MLP kernels and the lookup: sampling, sorting,
compositing, posenc, the projection and the casts. Moves view_rays_per_s."""

from harness.trace import FIELD_BUCKETS, MLP_BUCKETS


def read(run):
    if run.trace is None or run.units == 0:
        return None
    spent = run.trace.seconds(span="bench.render",
                              exclude=set(FIELD_BUCKETS) | set(MLP_BUCKETS) | {"lookup kernels"})
    return 1e3 * spent / run.units if spent > 0 else None
