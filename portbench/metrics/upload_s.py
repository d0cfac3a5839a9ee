"""upload_s, apply (each column group's source window converted on the
host and copied to the device: the ``apply.upload`` spans inside
``interp_data``): seconds per hour, from the program's spans (host clock,
no synchronize), the mean over the window's hours. None where the program
records no such span."""


def read(ctx):
    return ctx["stage_mean"](("apply.upload",))
