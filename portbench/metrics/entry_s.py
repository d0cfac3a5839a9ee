"""entry_s, CLI entry (the routing and input checks, ``route_fields``, and
the Morton renumbering of the source cells, ``reorder_cells``): seconds per
hour, from the program's spans (host clock, no synchronize), the mean over
the window's hours. None where the program records neither span."""


def read(ctx):
    return ctx["stage_mean"](("route_fields", "reorder_cells"))
