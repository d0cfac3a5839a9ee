"""kernel_roofline: the least time the hour's regrids allow when each byte
of their problem (``problem.apply_bytes``) moves once at the card's
memory bandwidth, over the device time of every kernel inside
``interp_data``, in %. A bound of bytes: the regrids do 2 operations per
nonzero and column, far below the card's f32 peak."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    win = tr.stage_windows("interp_data")
    t = tr.device_time(win, lambda e: e.get("cat") == "kernel")
    if t <= 0:
        return None
    bound = ctx["apply_bytes"]() / ctx["peak_bytes_s"]
    return 100.0 * bound * len(ctx["hours"]) / t
