"""interp_s, apply (the upload, the kernels and the fetch): seconds per
hour, from the program's ``Timings`` (host clock, each stage ending with a
synchronize), the mean over the window's hours."""


def read(ctx):
    return ctx["stage_mean"](("interp_data",))
