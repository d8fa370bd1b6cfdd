"""encoder_ms.train: device milliseconds a step in the trunk's convolution
kernels (cuDNN, forward and both gradients). BatchNorm runs as plain
elementwise kernels that no name tells apart, so it is not in here.
Moves train_rays_per_s."""


def read(run):
    if run.trace is None or run.units == 0:
        return None
    spent = run.trace.seconds({"cuDNN convolutions"}, span="bench.step")
    return 1e3 * spent / run.units if spent > 0 else None
