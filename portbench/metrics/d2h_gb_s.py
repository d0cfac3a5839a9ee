"""d2h_gb_s: the bytes each hour has to bring to the host (its regridded
output variables, ``problem.fetch_bytes``) over the device time of the
device-to-host copies inside ``interp_data``, in GB/s. From the trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    win = tr.stage_windows("interp_data")
    t = tr.device_time(win, lambda e: e.get("cat") == "gpu_memcpy"
                       and "DtoH" in e.get("name", ""))
    if t <= 0:
        return None
    return ctx["fetch_bytes"] * len(ctx["hours"]) / t / 1e9
