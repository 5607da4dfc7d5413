"""backward_device_ms.grad: device ms of the per-depth backward's phases
(F-grad and each depth's G phase, timed by CUDA event pairs around their
replays: the `device_ms.F-grad` and `device_ms.G...` counters), the mean
over the window's train steps."""
from pbh import spans


def _backward(phase):
    return phase == "F-grad" or phase.startswith("G")


def read(run):
    got = spans.split(run)
    if got is None:
        return None
    ms = [spans.device_ms(r, _backward) for r in got[1]]
    return sum(ms) / len(ms) if all(ms) else None
