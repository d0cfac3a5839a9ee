"""pack_s, weights (every tile pack, each method's and the union of the
cell methods, loaded from the weight cache or built: the ``weights.pack``
spans, under ``weight_generation`` and ``interp_data``): seconds per hour,
from the program's spans (host clock, no synchronize), the mean over the
window's hours. None where the program records no such span."""


def read(ctx):
    return ctx["stage_mean"](("weights.pack",))
