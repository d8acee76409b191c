"""Device ms a step of the frozen UNet-ResNet34 over the batch's views: the
program's own ``lift.unet`` span (``mvkpconv_tpu_torch.tracing``, its CUDA
events), mean over the traced run's pass over the pool after the window."""

from portbench.readers import program_span_ms


def read(run):
    return program_span_ms(run, "lift.unet", "infer")
