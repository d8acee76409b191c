"""Device ms a step of the 2D branch and lift: the model's forward less its
trunk (the UNet, the unprojection, K2, the lift gather, FeatureAggregation,
the influence cache), CUDA events, mean over the window's steps."""

from portbench.readers import mean_span


def read(run):
    return mean_span(run, "lift", "infer")
