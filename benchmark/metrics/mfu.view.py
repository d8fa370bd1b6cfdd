"""mfu.view: a view's model operations (the ResnetFC products forward at
the view's rays, the trunk's convolutions over the sources) of every view
of the run's untraced window over its host time, first start to last
end, against the bf16 peak. Moves view_rays_per_s."""

from harness.counts import PEAK_BF16_FLOPS


def read(run):
    if run.timed_units == 0 or run.timed_s <= 0:
        return None
    return 100.0 * run.work["model_flops"] * run.timed_units / run.timed_s / PEAK_BF16_FLOPS
