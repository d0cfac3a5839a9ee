"""fetch_s, apply (each column group's result brought to the host, strip
by strip and row chunk by row chunk: the ``apply.fetch`` spans inside
``interp_data``; a fetch includes its wait for the group's kernel):
seconds per hour, from the program's spans (host clock, no synchronize),
the mean over the window's hours. None where the program records no such
span."""


def read(ctx):
    return ctx["stage_mean"](("apply.fetch",))
