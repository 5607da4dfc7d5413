"""The program's own spans and counters for the per-layer readers: the
requests that the port's recorder (`pbrlab_tpu_torch.utils.profiling`)
kept in the run's process, split into set-up's and the window's.

A kind's requests are the recorder's requests of the name its class
gives (`SPAN_REQUEST`: `render` for render, `progressive.pass` for
preview, `train.step` for grad), in order. The window's are the
`run.attempted` that follow set-up's, of which the kind says how many
there are (`run.setup_requests()`: the render kind's `warmup` calls, the
preview kind's `warmup_passes` and its edit pass, the grad kind's
`ref_steps` steps). Set-up's requests are every request of any name that
finished before the window's first (the fat tables' build and the
kernel library's load among them). The traced slice's requests come
after the window and are left out.

`split` gives None where there is nothing to read: a kind that names no
request, a program without the recorder (an older checkout), the
recorder off (PBRLAB_TRACE=0), fewer requests than the window's, or a
ring that dropped records.
"""
from __future__ import annotations

# the spans of building a phase's graph: its eager warm-up, its capture
# and its instantiation
BUILD = ("graphs.warmup", "graphs.capture", "graphs.instantiate")


def _profiling():
    try:
        from pbrlab_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records"):
        return None
    return profiling


def split(run):
    """(set-up's requests, the window's requests) of `run` (a kind after
    its window), each a list of `profiling.records()` entries; or None."""
    profiling = _profiling()
    name = getattr(type(run), "SPAN_REQUEST", None)
    if profiling is None or name is None:
        return None
    recs = profiling.records()
    if not recs or any(profiling.dropped().values()):
        return None
    mine = [r for r in recs if r["name"] == name]
    first = run.setup_requests()
    window = mine[first:first + run.attempted]
    if not run.attempted or len(window) < run.attempted:
        return None
    setup = [r for r in recs if r["id"] < window[0]["id"]]
    return setup, window


def span_ms(requests, names):
    """Host ms of the requests' spans named in `names`."""
    return sum(s["dur_ns"] for r in requests for s in r["spans"]
               if s["name"] in names) / 1e6


def counter(requests, name):
    """The requests' counter `name`, summed."""
    return sum(r["counters"].get(name, 0) for r in requests)


def device_ms(request, phases=None):
    """Event-timed device ms of a request's replayed phases (those in
    `phases`, a predicate on the phase name; None: all)."""
    return sum(v for k, v in request["counters"].items()
               if k.startswith("device_ms.")
               and (phases is None or phases(k.split(".", 1)[1])))
