"""Tokens of the whole steps run in the window over the time from its start
to the last step's end (read by its loss)."""


def read(ctx):
    if "train_tokens" not in ctx:
        return None
    return ctx["train_tokens"] / ctx["window_s"]
