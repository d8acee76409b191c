"""The card's peak of allocated memory over the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start), GiB."""


def read(run):
    return run["peak_bytes"] / 2**30 if "peak_bytes" in run else None
