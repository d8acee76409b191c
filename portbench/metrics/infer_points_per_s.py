"""Real level-0 points whose probabilities reached the host in the window,
over the window's seconds; host clock."""


def read(run):
    return run["points"] / run["window_s"] if run["kind"] == "infer" else None
