"""Device ms a step of PointNet++'s index work: the farthest point sampling
(P1), the brute-force ball query and the brute-force 3-NN search, the
program's own ``pn2.fps``, ``pn2.ball_query`` and ``pn2.three_nn`` spans
summed (each over its four levels), mean over the traced run's pass over
the pool after the window."""

from portbench.readers import program_span_ms

SPANS = ("pn2.fps", "pn2.ball_query", "pn2.three_nn")


def read(run):
    parts = [program_span_ms(run, span, "infer") for span in SPANS]
    return None if any(p is None for p in parts) else sum(parts)
