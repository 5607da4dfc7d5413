"""subiters_per_msample.render: the render loop's sub-iterations
(`render_lanes_wavefront(..., return_iters=True)`) summed over the
window's renders, per million pixel samples. It repeats exactly for a
given scene, size and seeds."""


def read(run):
    w = run.window
    if "subiters" not in w or not w.get("samples"):
        return None
    return w["subiters"] / (w["samples"] / 1e6)
