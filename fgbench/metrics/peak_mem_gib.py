"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats() at its start; None off a card."""


def read(run):
    if run.device_type != "cuda":
        return None
    return run.peak_bytes / 2 ** 30
