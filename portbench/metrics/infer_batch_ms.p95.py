"""95th percentile over every batch of the window of the time from the
hand-off of its host arrays until its probabilities are on the host, ms;
host clock."""

import numpy as np


def read(run):
    if run["kind"] != "infer" or not run["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(run["latencies_s"], 95))
