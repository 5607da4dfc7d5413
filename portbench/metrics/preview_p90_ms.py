"""preview_p90_ms: the 90th percentile (nearest rank) of the wall of
every pass in the window, edit passes included."""
from pbh.common import nearest_rank


def read(run):
    ms = run.window.get("pass_ms")
    return nearest_rank(ms, 0.9) if ms else None
