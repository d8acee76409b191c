"""The whole step's share of the card's peak: the window's steps' counted
FLOPs at the published peak of the precision each class runs at under the
configuration's TF32 switches (the UNet's convolutions at TF32 where cuDNN
may use it, else at float32; the rest likewise by the matmul switch;
counting.py) over the window's seconds, %."""

from portbench.readers import mfu_percent


def read(run):
    return mfu_percent(run, "infer")
