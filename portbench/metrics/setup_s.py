"""Set-up: process start to the window's start (loading, weights, warm-up,
and in a checkout's first run the CUDA build)."""


def read(ctx):
    return ctx["setup_s"]
