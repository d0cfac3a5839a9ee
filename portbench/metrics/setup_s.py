"""setup_s: from the harness's start to the window's: import torch, the
CUDA context, the inputs, the kernel builds or loads and the warm-up
hour."""


def read(ctx):
    return ctx["setup_s"]
