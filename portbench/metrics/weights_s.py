"""weights_s, weights (a cache load when warm, the whole build when cold):
seconds per hour, from the program's ``Timings`` (host clock, each stage
ending with a synchronize), the mean over the window's hours."""


def read(ctx):
    return ctx["stage_mean"](("weight_generation",))
