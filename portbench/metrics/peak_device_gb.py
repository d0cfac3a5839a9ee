"""peak_device_gb: torch.cuda.max_memory_allocated over the window (reset
when it starts), in GB, on the fullest device."""


def read(ctx):
    return ctx["peak_device_bytes"] / 1e9
