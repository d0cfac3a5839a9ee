"""write_transform_s, writer (the in-memory writer's own work, its
float32 copies, ``moveaxis`` and float64 passes: ``write_to_file`` less
its ``write.store`` children, the calls that hand the file or the sink its
data): seconds per hour, from the program's spans (host clock), the mean
over the window's hours. None where the program records no store, and in
a streamed run, whose stores run on the writer's thread (``write.block``)
rather than inside ``write_to_file``."""


def read(ctx):
    hours = ctx["hours"]
    if any("write.block" in h["stages"] for h in hours):
        return None
    whole = ctx["stage_mean"](("write_to_file",))
    stores = ctx["stage_mean"](("write.store",))
    if whole is None or stores is None:
        return None
    return whole - stores
