"""setup_s: seconds from the process's start to the first timed step
(inputs drawn, the program and its kernels loaded, one warm step)."""


def read(ctx):
    return ctx["setup_s"]
