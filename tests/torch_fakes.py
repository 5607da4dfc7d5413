"""A fake `torch.cuda` for the graph runner's bookkeeping on the CPU
(`render.graphs.GraphRunner(cuda=FakeCuda())`): a capture runs the phase
(a real capture records it), a replay only counts, and a timing event is
complete once recorded, 1 ms after the event recorded before it."""
import contextlib


class FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph."""
    fail_replay = False

    def __init__(self, keep_graph=False):
        assert keep_graph
        self.replays = 0
        self.instantiated = False

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        if FakeGraph.fail_replay:
            raise RuntimeError("replay failed")
        assert self.instantiated
        self.replays += 1


class FakeEvent:
    """A stand-in for torch.cuda.Event; `made` counts the events made."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.t = FakeEvent.clock

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class FakeCuda:
    CUDAGraph = FakeGraph
    Event = FakeEvent

    def __init__(self):
        self.captures = []

    def graph_pool_handle(self):
        return ("pool",)

    @contextlib.contextmanager
    def graph(self, graph, pool):
        assert pool == ("pool",)
        self.captures.append(graph)
        yield
