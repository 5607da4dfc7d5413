"""step_busy_ms_per_subiter.render: device busy milliseconds of the
profiled slice over its sub-iterations."""


def read(run):
    s = run.slice
    if not s or not s.get("subiters") or not s["busy_s"]:
        return None
    return s["busy_s"] * 1e3 / s["subiters"]
