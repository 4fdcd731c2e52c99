"""torch.cuda.max_memory_allocated() over the window, reset at its start, in GB."""


def read(w):
    return w.peak_bytes / 1e9
