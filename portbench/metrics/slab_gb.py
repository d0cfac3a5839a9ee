"""slab_gb, kernels (what the packed routes' tiles stage from the source:
the program's counter ``apply.slab_bytes``, each launch's tiles x slab
rows x its columns x 4 bytes): GB per hour, the mean over the window's
hours. ``kernel_roofline`` counts each source byte once; this shows how
many times over a pack reads it. None where the program counts no such
bytes."""


def read(ctx):
    v = ctx["count_mean"](("apply.slab_bytes",))
    return None if v is None else v / 1e9
