"""Process start to the window's opening: drawing the weights, building the
engine and its kernels, the warm-up (s)."""


def read(ctx):
    return ctx.setup_s
