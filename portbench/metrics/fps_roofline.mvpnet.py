"""P1's share of its roofline, %: the least time of a step's farthest point
samplings (the four set abstractions' of every chunk, 9 operations a point
a step at the float32 peak; ``portbench.reference_mvpnet.fps_seconds`` at
the configuration ``mvpnet``'s sizes) over the device ms of the program's
own ``pn2.fps`` spans (P1's launch alone), mean over the traced run's pass
over the pool after the window."""

from portbench import harness
from portbench.readers import program_span_ms
from portbench.reference_mvpnet import fps_seconds


def read(run):
    ms = program_span_ms(run, "pn2.fps", "infer")
    if not ms:
        return None
    return 100.0 * fps_seconds(harness.load_config("mvpnet")["model"]) * 1e3 / ms
