"""ingest_s, host ingest (the target grid, the mesh and the fields read):
seconds per hour, from the program's ``Timings`` (host clock, each stage
ending with a synchronize), the mean over the window's hours."""


def read(ctx):
    return ctx["stage_mean"](("define_target_grid", "define_input_grid",
                              "read_input_data"))
