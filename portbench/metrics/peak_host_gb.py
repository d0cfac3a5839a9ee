"""peak_host_gb: the process's peak resident memory (``ru_maxrss``) in GB.
It is the whole process's: what only a cell's first run makes is made in
a process of its own (``prepare.py``), set-up holds less than an hour
(``peak_host_before_warmup`` on standard error), and its warm-up hour is
an hour like the window's."""


def read(ctx):
    b = ctx["peak_host_bytes"]
    return None if b is None else b / 1e9
