"""device_idle_share.<cells>: 1 - device busy / wall, in %, of the
profiled slice: busy is the union of the slice's device intervals in the
trace, the wall that of the same slice run just before without the
profiler (a render: the same call, the same seed; passes or a train
step: the same shapes). Even recording device activity alone, the
profiler's record of every graph node stretches the traced wall 1.7-2.1x,
so the traced wall would measure the profiler. One reader for every
`device_idle_share.*` metric."""


def read(run):
    s = run.slice
    if not s or not s.get("untraced_s") or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["untraced_s"])
