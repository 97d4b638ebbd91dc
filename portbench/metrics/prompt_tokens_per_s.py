"""All prompt tokens of the window's whole calls over the window's
host-clock time, from the first call's send to the last call's first
tokens on the host."""


def value(run):
    if not run.window.items:
        return None
    return sum(it["tokens"] for it in run.window.items) / run.window.seconds
