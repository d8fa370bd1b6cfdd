"""idle_pct.view: the share of the traced window in which no operation
ran on the device. Moves view_rays_per_s."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
