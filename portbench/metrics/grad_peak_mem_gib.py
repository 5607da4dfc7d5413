"""grad_peak_mem_gib: the device memory in use over the window, GiB: the
largest of the driver's readings (total - free, `cudaMemGetInfo`) taken
after each train step, once set-up's unused cache was given back. It
counts what the steps hold on the card: the kept programs' graph pools,
the tensors of the step, the allocator's cache and the CUDA context."""


def read(run):
    b = run.window.get("device_used_bytes")
    return None if b is None else b / 2 ** 30
