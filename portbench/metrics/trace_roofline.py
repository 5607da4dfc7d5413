"""trace_roofline: the trace kernels' (dense_v4, dense_v5, dense_v5l)
share of their bytes roofline in the profiled slice: their launches'
bytes (`pbh.roofline`) at the card's peak bandwidth over their device
time, in %. None where the slice launched no trace kernel."""
from pbh import roofline


def read(run):
    s = run.slice
    if not s:
        return None
    bound, spent = roofline.bound_share(s["kernels"], run.table_bytes)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
