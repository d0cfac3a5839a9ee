"""hour_s: the window's wall clock over the hours completed in it."""


def read(ctx):
    if not ctx["hours"]:
        return None
    return ctx["window_s"] / len(ctx["hours"])
