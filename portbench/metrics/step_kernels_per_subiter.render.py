"""step_kernels_per_subiter.render: device kernels of the profiled slice
(one render at the cell's lane count) over the slice's sub-iterations."""


def read(run):
    s = run.slice
    if not s or not s.get("subiters") or not s["kernels"]:
        return None
    return len(s["kernels"]) / s["subiters"]
