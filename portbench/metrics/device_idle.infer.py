"""Share of the profiled stretch of a traced run in which no kernel, copy or
fill ran on the card: 1 − (union of their intervals) / wall, %."""

from portbench.readers import idle_percent


def read(run):
    return idle_percent(run, "infer")
