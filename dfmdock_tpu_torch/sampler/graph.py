"""One CUDA graph per sample: the samplers' counterpart of the JAX package's
one program per sample (`dfmdock_tpu/sampler/em.py` `sample_jit`, one
jitted scan per shape, compiled at first use and run from then on).

A sampler hands `SampleGraphs.run` its body, the whole sample from the
start pose to the final forward, which reads only the inputs it is given
and draws only from the generator it is given, with a shape key.  On CPU
tensors (or with `capture=False`) the body runs eagerly on the caller's
inputs and generator.  On CUDA tensors the first call of a key

- copies the inputs into static buffers of its own;
- warms up on a side stream: the body's warm-up form (one step and the
  final forward), which builds what the body keeps between calls (the
  fused route's prepared weights, models/egnn.fused_weights);
- captures the body as one CUDA graph into a memory pool that every graph
  of the helper shares (replays run one after another on one stream, and
  each call's outputs are cloned before the next replay).

The helper owns one generator, registered with every graph it captures;
the warm-up and the capture draw from it, never from the caller's.  Every
call, the first included, copies its inputs into the buffers and the
caller's generator state into the helper's, replays the graph (which draws
from that state and advances it by what the sample draws, as the eager
sample does), copies the state back to the caller's generator and returns
clones of the outputs, so that a later replay cannot overwrite what a
caller holds.  A capture that fails raises; there is no eager fallback on
CUDA.

The cache key is the caller's key, each input's shape and dtype and the
data_ptr and _version of every parameter and buffer of the module: weights
loaded in place drop every graph, and the next call captures again.

Launch counts (`ops.launch_counts`) stay the wrappers' own: a wrapper counts
where it is called, in the warm-up (a launch) and in the capture (a launch
the graph records, which executes nothing); a replay calls no wrapper.
`GraphStats` keeps what the captures recorded and what the replays ran
(each replay the launches its graph recorded), beside the warm-ups', so
that a profiler trace of the kernels a run executed can be held against
them (chip_smoke.py's run_path).
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import torch

from dfmdock_tpu_torch.ops import launch_counts


@dataclasses.dataclass
class GraphStats:
    """Captures made, replays run, host seconds spent warming up and
    capturing, and launches: the warm-ups' (run), the captures' (recorded)
    and the replays' (each replay its graph's recorded launches)."""
    captures: int = 0
    replays: int = 0
    capture_s: float = 0.0
    warmup_launches: dict = dataclasses.field(default_factory=dict)
    captured_launches: dict = dataclasses.field(default_factory=dict)
    replayed_launches: dict = dataclasses.field(default_factory=dict)

    def add(self, captures=0, replays=0, capture_s=0.0, warmup=None, captured=None,
            replayed=None):
        self.captures += captures
        self.replays += replays
        self.capture_s += capture_s
        _accumulate(self.warmup_launches, warmup or {})
        _accumulate(self.captured_launches, captured or {})
        _accumulate(self.replayed_launches, replayed or {})


TOTALS = GraphStats()  # every helper's stats, summed (reset_totals zeroes them)


def totals() -> GraphStats:
    """A copy of the stats of every helper since the last reset_totals()."""
    return dataclasses.replace(TOTALS, warmup_launches=dict(TOTALS.warmup_launches),
                               captured_launches=dict(TOTALS.captured_launches),
                               replayed_launches=dict(TOTALS.replayed_launches))


def reset_totals():
    global TOTALS
    TOTALS = GraphStats()


def _accumulate(into: dict, delta: dict):
    for k, v in delta.items():
        if v:
            into[k] = into.get(k, 0) + v


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


def tree_map(fn, tree):
    """`fn` over the tensors of a tree of dicts, tuples and lists (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"a sample's inputs and outputs are tensors, not {type(tree).__name__}")


def _spec(tree):
    """The hashable structure of a tree: each tensor's shape, dtype and device."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, dict):
        return tuple((k, _spec(tree[k])) for k in sorted(tree))
    return tuple(_spec(v) for v in tree)


def _copy_into(static, tree):
    if isinstance(static, torch.Tensor):
        if static is not tree:
            static.copy_(tree)
    elif isinstance(static, dict):
        for k, v in static.items():
            _copy_into(v, tree[k])
    elif static is not None:
        for s, t in zip(static, tree):
            _copy_into(s, t)


def _device(tree) -> torch.device:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves[0].device


def params_key(module: torch.nn.Module) -> tuple:
    """Every parameter's and buffer's storage and version."""
    return tuple((t.data_ptr(), t._version)
                 for t in itertools.chain(module.parameters(), module.buffers()))


class CudaGraphs:
    """The card's capture: the warm-up on a side stream, the capture with the
    generator registered, every graph in one memory pool."""

    device_type = "cuda"

    def __init__(self):
        self.pool = None

    def warmup(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self, fn, generator):
        """(the graph, fn's outputs as recorded)."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=self.pool):
            outputs = fn()
        return graph, outputs


@dataclasses.dataclass
class _Entry:
    graph: object
    inputs: object
    outputs: object
    per_replay: dict


class SampleGraphs:
    """The graphs of one sampler (or of a loop of ranking draws), one per
    cache key; module docstring.  `backend` is the capture (CudaGraphs;
    tests pass a stand-in that runs on the CPU)."""

    def __init__(self, backend=None):
        self.backend = backend or CudaGraphs()
        self.graphs = {}
        self.params = None
        self.generator = None  # registered with every graph; made at the first capture
        self.stats = GraphStats()

    def capture_device(self, device: torch.device) -> bool:
        """Whether `device` is the one the backend captures on (CUDA): a
        sample there, captured or not, takes the nets' static inputs."""
        return device.type == self.backend.device_type

    def captures_on(self, device: torch.device, capture: bool | None) -> bool:
        """Whether a call on `device` captures: by default where the backend
        runs (CUDA); `capture=True` elsewhere raises, `capture=False` runs
        eagerly."""
        on = self.capture_device(device)
        if capture and not on:
            raise ValueError(f"capture=True needs {self.backend.device_type} tensors; a "
                             f"sample on {device} runs eagerly")
        return on if capture is None else capture

    def run(self, module, key, inputs, body, generator, capture: bool | None = None):
        """body(inputs, generator) -> {name: tensor}: eagerly, or as the
        replay of the graph of (key, the inputs' shapes, module's weights)
        drawing from `generator`'s state.  body(inputs, generator,
        warmup=True) is the warm-up form."""
        device = _device(inputs)
        if not self.captures_on(device, capture):
            return body(inputs, generator)
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"a captured sample needs the net as a torch.nn.Module (its "
                            f"weights key the graphs), not {type(module).__name__}; a net "
                            f"that runs Python each forward samples with capture=False")
        if generator is None:
            raise ValueError("a captured sample draws from a generator: pass one, or "
                             "capture=False")
        weights = params_key(module)
        if weights != self.params:
            self.graphs.clear()
            self.params = weights
        sig = (key, _spec(inputs))
        entry = self.graphs.get(sig)
        if entry is None:
            entry = self.graphs[sig] = self._capture(inputs, body, device)
        else:
            _copy_into(entry.inputs, inputs)
        self.generator.set_state(generator.get_state())
        entry.graph.replay()
        generator.set_state(self.generator.get_state())
        for stats in (self.stats, TOTALS):
            stats.add(replays=1, replayed=entry.per_replay)
        return tree_map(torch.Tensor.clone, entry.outputs)

    def _capture(self, inputs, body, device) -> _Entry:
        t0 = time.perf_counter()
        if self.generator is None:
            self.generator = torch.Generator(device)
        static = tree_map(torch.Tensor.clone, inputs)
        before = launch_counts()
        self.backend.warmup(lambda: body(static, self.generator, warmup=True))
        warm = launch_counts()
        graph, outputs = self.backend.capture(lambda: body(static, self.generator),
                                              self.generator)
        recorded = _delta(launch_counts(), warm)
        for stats in (self.stats, TOTALS):
            stats.add(captures=1, capture_s=time.perf_counter() - t0,
                      warmup=_delta(warm, before), captured=recorded)
        return _Entry(graph, static, outputs, recorded)
