"""torch.cuda.max_memory_allocated over set-up and window, in GiB."""


def read(record):
    b = record["peak_mem_bytes"]
    return None if b is None else b / 2 ** 30
