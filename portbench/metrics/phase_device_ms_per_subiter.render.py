"""phase_device_ms_per_subiter.render: device ms of the window's replayed
phases, each timed by a pair of CUDA events around its replay (the
`device_ms.<phase>` counters), per sub-iteration: the untraced twin of
`step_busy_ms_per_subiter.render`. An event pair also holds the stall
between the host's launch and the graph's first kernel, where a read
had left the stream empty; the warm-up sub-iteration of each render
runs eagerly and is left out of the sum."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None or not spans.counter(got[1], "subiters"):
        return None
    window = got[1]
    ms = sum(spans.device_ms(r) for r in window)
    return ms / spans.counter(window, "subiters") if ms else None
