"""setup_s: process start to the first measured call (imports, CUDA
context, the program's set-up from the seed, warm-up), in seconds."""


def read(tr, ctx):
    return ctx["setup_s"]
