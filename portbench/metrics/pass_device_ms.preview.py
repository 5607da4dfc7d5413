"""pass_device_ms.preview: the 90th percentile (nearest rank) over the
window's passes of each pass's device ms, its program's phases timed by
CUDA event pairs around their replays (the `device_ms.<phase>`
counters)."""
from pbh import spans
from pbh.common import nearest_rank


def read(run):
    got = spans.split(run)
    if got is None:
        return None
    ms = [spans.device_ms(r) for r in got[1]]
    return nearest_rank(ms, 0.9) if all(ms) else None
