"""Peak device memory allocated in the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    if run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / float(1 << 30)
