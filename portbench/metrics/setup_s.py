"""Set-up seconds: from the start of the process (imports, the card, the
kernel library, the traffic pool, the weights and their calibration, the
program, the warm-up) to the start of the window; host clock."""


def read(run):
    return run["setup_s"]
