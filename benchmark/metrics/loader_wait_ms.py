"""Loader: the mean host time a step waits in ``next()`` on the loader,
over the window's steps."""


def read(ctx):
    waits = ctx["window"]["wait_ms"]
    return sum(waits) / len(waits) if waits else None
