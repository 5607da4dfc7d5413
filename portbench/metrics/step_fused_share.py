"""step_fused_share.<cells>: the share of the window's wavefront steps
that ran as `ops.step`'s two kernels, in %: the requests' counters
`launches.step.fused` over `launches.step.fused` + `launches.step.chain`
(the steps that ran as the torch chain), summed over the window's
requests. Both count on a CUDA device only, so the CPU reads nothing.
One reader for every `step_fused_share.*` metric."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None:
        return None
    fused = spans.counter(got[1], "launches.step.fused")
    steps = fused + spans.counter(got[1], "launches.step.chain")
    return 100.0 * fused / steps if steps else None
