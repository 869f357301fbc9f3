"""setup_s (s, host clock): from the process's start to the window's:
imports, loading the built kernels (building them on a checkout's first
run), the phase field and solver on the device, and the warm-up request."""


def read(run):
    return run.setup_s
