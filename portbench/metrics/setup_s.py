"""Set-up: seconds from the process's start to the first timed step or
request (imports, kernels loaded or built, weights drawn on the card, the
warm-up and the check's first steps)."""


def value(run):
    return run.setup_s
