"""sync_wait_ms_per_subiter.render: host ms blocked in the render loop's
reads of its probe (the `graphs.read` spans: the loop test a trip, the
window test a sub-iteration) over the window's renders, per
sub-iteration."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None or not spans.counter(got[1], "subiters"):
        return None
    window = got[1]
    return (spans.span_ms(window, ("graphs.read",))
            / spans.counter(window, "subiters"))
