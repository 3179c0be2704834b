"""A stand-in for sampler/graph.py's capture backend on the CPU: a
"capture" runs the body once (a CUDA graph's capture draws nothing: the
body draws from the helper's own generator, whose state every replay sets);
a "replay" runs the body again, its Python launch counting undone (a
replay calls no wrapper), and writes its outputs into the recorded ones."""
from dfmdock_tpu_torch.ops import _counters
from dfmdock_tpu_torch.sampler.graph import tree_map


class _StubGraph:
    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        counters = _counters().values()
        saved = [getattr(fn, attr) for fn, attr in counters]
        new = self.fn()
        for (fn, attr), v in zip(counters, saved):
            setattr(fn, attr, v)
        out = []
        tree_map(out.append, self.outputs)
        src = []
        tree_map(src.append, new)
        for o, n in zip(out, src):
            o.copy_(n)


class StubGraphs:
    """The capture backend's stand-in (module docstring)."""

    device_type = "cpu"

    def warmup(self, fn):
        fn()

    def capture(self, fn, generator):
        outputs = fn()
        return _StubGraph(fn, outputs), outputs
