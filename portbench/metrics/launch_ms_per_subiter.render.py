"""launch_ms_per_subiter.render: host ms inside the graphs' `replay()`
(the `graphs.launch` spans) over the window's renders, per
sub-iteration (the `subiters` counter)."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None or not spans.counter(got[1], "subiters"):
        return None
    window = got[1]
    return (spans.span_ms(window, ("graphs.launch",))
            / spans.counter(window, "subiters"))
