"""Generated tokens in the window (the engine's ``generated`` counter) over
the window's seconds."""


def read(ctx):
    if "generated" not in ctx:
        return None
    return ctx["generated"] / ctx["window_s"]
