"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
its statistics reset at the end of the warm-up."""


def read(win) -> float:
    return win.peak_bytes / 2**30
