"""setup_graph_s.<cells>: host seconds set-up spends building graphs
(the eager warm-ups, captures and instantiations of every phase: the
`graphs.warmup`, `graphs.capture` and `graphs.instantiate` spans) over
the requests that finished before the window. One reader for every
`setup_graph_s.*` metric."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None:
        return None
    return spans.span_ms(got[0], spans.BUILD) / 1e3
