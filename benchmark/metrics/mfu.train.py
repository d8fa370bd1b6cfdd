"""mfu.train: the step's model operations (`counts.cell_work`: the ResnetFC
products forward and backward, the trunk's convolutions) of every step of
the run's untraced window over its host time, ended by a sync, against
the bf16 peak. Moves train_rays_per_s."""

from harness.counts import PEAK_BF16_FLOPS


def read(run):
    if run.timed_units == 0 or run.timed_s <= 0:
        return None
    return 100.0 * run.work["model_flops"] * run.timed_units / run.timed_s / PEAK_BF16_FLOPS
