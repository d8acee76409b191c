"""Device ms a step of the trunk and head (the encoders', decoder's and head's
forwards), CUDA events from forward hooks, mean over the window's steps."""

from portbench.readers import mean_span


def read(run):
    return mean_span(run, "trunk", "infer")
