"""restagger_s, apply (the second regrid of the staggered winds, mass
points onto U and onto V: the ``restagger`` spans inside ``interp_data``,
one a wind, each holding its source's preparation, the pole rows of a
periodic grid's V included, and its apply's upload and fetch): seconds per
hour, from the program's spans (host clock), the mean over the window's
hours. None where the program records no such span."""


def read(ctx):
    return ctx["stage_mean"](("restagger",))
