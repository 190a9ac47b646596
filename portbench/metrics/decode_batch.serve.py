"""Requests a decode step served, on average over the window:
(generated tokens - fresh prefills' first tokens) / decode steps."""


def read(ctx):
    c = ctx.get("counters")
    if c is None or c["decode_steps"] <= 0:
        return None
    return (c["generated"] - c["prefills"]) / c["decode_steps"]
