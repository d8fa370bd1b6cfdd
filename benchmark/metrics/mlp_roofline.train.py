"""mlp_roofline.train: the least time of a step's ResnetFC forward-with-stash
and backward calls (`counts.mlp_stash_forward`, `counts.mlp_backward`)
over the device time of the MLP kernels (the block chains, the layered
path, the weight-gradient products). Moves train_rays_per_s."""

from harness.trace import MLP_BUCKETS


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(MLP_BUCKETS)
    if spent <= 0:
        return None
    return 100.0 * run.work["mlp_least_s"] * run.units / spent
