"""write_s, writer (the host transforms into what the sink receives):
seconds per hour, from the program's ``Timings`` (host clock, each stage
ending with a synchronize), the mean over the window's hours."""


def read(ctx):
    return ctx["stage_mean"](("write_to_file",))
