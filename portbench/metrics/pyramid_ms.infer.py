"""Device ms a step of the input pyramid (``build_pyramid`` as the step calls
it: the grid subsamples and K1's 13 selections), CUDA events, mean over the
window's steps."""

from portbench.readers import mean_span


def read(run):
    return mean_span(run, "pyramid", "infer")
