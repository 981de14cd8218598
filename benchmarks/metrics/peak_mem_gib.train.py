"""The train step's peak device memory over the traced window:
torch.cuda.max_memory_allocated after a reset at the end of set-up."""


def read(r):
    if r.memory_peak_bytes <= 0:
        return None
    return r.memory_peak_bytes / 2 ** 30
