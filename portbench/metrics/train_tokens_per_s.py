"""All tokens of the window's whole steps over the window's host-clock
time, from the first step's start to the last step's synchronized end."""


def value(run):
    if not run.window.items:
        return None
    return sum(it["tokens"] for it in run.window.items) / run.window.seconds
