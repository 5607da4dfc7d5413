"""graph_build_ms_per_call.render: host ms a render call spends building
its loop's graphs (each phase's eager warm-up, capture and
instantiation: the `graphs.warmup`, `graphs.capture` and
`graphs.instantiate` spans), the mean over the window's renders."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None:
        return None
    window = got[1]
    return spans.span_ms(window, spans.BUILD) / len(window)
