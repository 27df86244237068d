"""setup_s: seconds from the process's start to the window's start
(imports, loading or building the kernels, data, set-up, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
