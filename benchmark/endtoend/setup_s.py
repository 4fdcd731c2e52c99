"""From the process's first line to the end of the warm-up: imports, the
program's build (kernels from its cache, or built in a checkout's first
run), weights drawn on the device, and the warm-up evaluations."""


def read(w):
    return w.setup_s
