"""backward_busy_ms.grad: device milliseconds of the kernels launched
from inside the autograd engine's `_LanesGradBackward` node (the
per-depth backward) in the train step profiled with the host's
operators."""
from pbh import tracing


def read(run):
    s = (run.slice or {}).get("with_host")
    if not s:
        return None
    busy = tracing.busy_within(s, "_LanesGradBackward")
    return busy * 1e3 if busy else None
