"""Device ms a step of MVPNet's PointNet++ (the four set abstractions, the
four feature propagations and the head): the program's own ``pn2`` span
(``mvkpconv_tpu_torch.tracing``, its CUDA events), mean over the traced
run's pass over the pool after the window."""

from portbench.readers import program_span_ms


def read(run):
    return program_span_ms(run, "pn2", "infer")
