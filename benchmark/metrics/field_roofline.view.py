"""field_roofline.view: the least time of a view's fused lookup-and-field
primal calls (`counts.field_primal`, at the padded chunks the calls see)
over the device time of the fused field kernel. Moves view_rays_per_s."""

from harness.trace import FIELD_BUCKETS


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(FIELD_BUCKETS)
    if spent <= 0:
        return None
    return 100.0 * run.work["field_least_s"] * run.units / spent
