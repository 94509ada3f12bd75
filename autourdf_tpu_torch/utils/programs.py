"""Captured device programs: the port's counterpart of ``jax.jit`` and of the
JAX package's ``functools.lru_cache`` of compiled programs.

A :class:`Program` owns static input buffers, a function of them and the
output buffers the function returns.  On a CUDA device its first call
captures the function (``CUDAGraph.capture_begin`` / ``capture_end`` on a
side stream) into the program's own memory pool and replays it; every later
call replays it.  The first capture of a family of programs (the same
operations at other shapes or lengths) in a process is preceded by a
warm-up on a side stream: the kernel library's build, cuBLAS's handles and
the autograd engine's first backward are lazy set-up that must not land in a
capture.  On the CPU the same function runs on the same static buffers
without capture and its results are copied into static output buffers, so
the buffer plumbing is the same on both devices and the CPU tests reach all
of it but the capture itself.

Inputs go in by ``copy_`` into the static buffers, which are never rebound.
The outputs a call returns ARE the static output buffers: they hold until
the program's next call, so a caller clones what must outlive it.  An output
that would alias an input buffer is cloned inside the program, so outputs and
inputs never share memory.

A capture that fails raises; nothing falls back to running the function
eagerly on the card.  A function whose body waits on the host (``.item()``,
``float(t)``, a pageable copy, ``torch.nonzero``, ``torch.linalg.svd`` or
``eigh`` on CUDA) cannot be a program: the port's ICP, normals and
farthest-point pick go through their kernels (``csrc/geom.cu``) instead.
A program's body does not call another program: the functions that run as
programs by themselves (``ops/icp.py icp_point_to_point``) take
``eager=True`` inside another program's body.

Kernel launches: the kernels' wrappers count a launch on the host
(``ops/_cuda.py launch_counts``), which a replay does not pass through.  The
program records the counts its capture added and adds them again at every
replay; the warm-up's and the capture's own launches are taken back out, so
a run counts each launch once per call, as the eager loop does.

With spans on (``utils/telemetry.py``) a warm-up, a capture and a call (its
inputs copied in and the graph replayed, or the plain run) are each a span;
``counters`` counts them, spans or no spans.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import OrderedDict

import torch

from ..ops import _cuda
from .telemetry import span

# Programs kept alive (each holds its graph and its memory pool), as the JAX
# package's ``_batched_phases`` keeps ``lru_cache(maxsize=16)`` of them.
CACHE_SIZE = 16
_cache: OrderedDict[tuple, "Program"] = OrderedDict()

# (family, device) pairs warmed up in this process, and the stream each
# device's captures run on
_warmed: set[tuple] = set()
_capture_streams: dict[torch.device, torch.cuda.Stream] = {}

# One record per capture made in this process (name, capture and
# instantiation seconds, graph nodes, pool bytes), for the reports of
# chip_smoke.py; ``captures.clear()`` starts a new list.
captures: list[dict] = []

# Warm-ups, captures, replays (or plain runs) and programs dropped from the
# cache, in this process.
counters = {"warmups": 0, "captures": 0, "replays": 0, "evictions": 0}


def _flatten(tree, leaves: list):
    """Append the tensor (or None) leaves of ``tree`` to ``leaves``; returns
    the tree's structure.  Trees are tensors, None, tuples (NamedTuples
    included), lists and dicts: a Python number in an input would be frozen
    into the capture, so it belongs in the program's key instead."""
    if tree is None or isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        keys = tuple(tree)
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        return (type(tree), None, tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"a program takes and returns tensors, None, tuples, lists and dicts; "
                    f"got {type(tree).__name__}")


def _unflatten(spec, leaves):
    """Rebuild a tree of :func:`_flatten`'s structure from an iterator of
    leaves."""
    if spec is None:
        return next(leaves)
    kind, keys, subs = spec
    vals = [_unflatten(s, leaves) for s in subs]
    if kind is dict:
        return dict(zip(keys, vals))
    if kind is list or kind is tuple:
        return kind(vals)
    return kind(*vals)                                  # a NamedTuple


def _signature(spec, leaves) -> tuple:
    return (spec, tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                        for t in leaves))


def _static_copy(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t.detach())


def _graph_node_count(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph kept for instantiation by hand
    (``keep_graph=True``), by ``cuGraphGetNodes``."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return count.value


class Program:
    """A function of tensor trees captured once and replayed (on a CUDA
    device) or run on its static buffers (on the CPU).  ``name`` labels its
    capture record and names its family for the warm-up; ``warm``, where
    given, is what the warm-up runs instead of ``fn``; ``epochs``, the
    training epochs a call runs, goes into the capture's record."""

    def __init__(self, fn, name: str, warm=None, epochs: int | None = None):
        self.fn = fn
        self.name = self.family = name
        self.warm = warm
        self.epochs = epochs
        self.stats: dict = {}
        self._inputs: list | None = None
        self._in_spec = None
        self._outputs: list | None = None
        self._out_spec = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._delta: dict[str, int] = {}

    def __call__(self, *args):
        leaves: list = []
        spec = _flatten(args, leaves)
        fresh = self._inputs is None
        if fresh:
            self._in_spec = spec
            self._inputs = [None if t is None else _static_copy(t) for t in leaves]
            dev = next((t.device for t in leaves if t is not None), torch.device("cpu"))
            if dev.type == "cuda":
                self._capture(dev)
        counters["replays"] += 1
        with span("program.replay", device=True, family=self.family):
            if not fresh:
                if spec != self._in_spec or len(leaves) != len(self._inputs):
                    raise ValueError(f"program {self.name}: inputs of another structure")
                for buf, t in zip(self._inputs, leaves):
                    if (buf is None) != (t is None):
                        raise ValueError(f"program {self.name}: an input appeared or went away")
                    if buf is not None and t is not buf:
                        buf.copy_(t)
            if self._graph is not None:
                self._graph.replay()
                for k, n in self._delta.items():
                    _cuda.launch_counts[k] += n
            else:
                self._run_plain()
        return _unflatten(self._out_spec, iter(self._outputs))

    def _args(self):
        return _unflatten(self._in_spec, iter(self._inputs))

    def _run_plain(self) -> None:
        leaves: list = []
        spec = _flatten(self.fn(*self._args()), leaves)
        if self._outputs is None:
            self._out_spec = spec
            self._outputs = [None if t is None else _static_copy(t) for t in leaves]
            return
        for buf, t in zip(self._outputs, leaves):
            if buf is not None:
                buf.copy_(t.detach())

    def _capture(self, dev: torch.device) -> None:
        counts = dict(_cuda.launch_counts)
        try:
            self._warm_up_and_capture(dev)
        except BaseException:
            # a program that did not capture stays uncaptured: its next call
            # tries again (and raises again) instead of running eagerly
            self._inputs = self._outputs = self._graph = None
            raise
        finally:
            _cuda.launch_counts.update(counts)
        captures.append(self.stats)

    def _warm_up_and_capture(self, dev: torch.device) -> None:
        torch.cuda.synchronize(dev)
        warm_s = 0.0
        if (self.family, dev) not in _warmed:
            counters["warmups"] += 1
            t0 = time.perf_counter()
            with span("program.warmup", family=self.family):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    (self.warm or self.fn)(*self._args())
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
            warm_s = time.perf_counter() - t0
            _warmed.add((self.family, dev))
        before = dict(_cuda.launch_counts)
        reserved = torch.cuda.memory_reserved(dev)
        # kept for instantiation by hand: capture and instantiation are timed apart
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        in_storage = {t.untyped_storage().data_ptr() for t in self._inputs if t is not None}
        if dev not in _capture_streams:
            _capture_streams[dev] = torch.cuda.Stream(dev)
        stream = _capture_streams[dev]
        counters["captures"] += 1
        with span("program.capture", family=self.family) as sp:
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="global")
                try:
                    leaves: list = []
                    self._out_spec = _flatten(self.fn(*self._args()), leaves)
                    self._outputs = [
                        None if t is None
                        else t.detach().clone() if t.untyped_storage().data_ptr() in in_storage
                        else t.detach()
                        for t in leaves]
                except BaseException:
                    with contextlib.suppress(RuntimeError):   # the capture was invalidated
                        graph.capture_end()
                    raise
                graph.capture_end()
            t1 = time.perf_counter()
            nodes = _graph_node_count(graph)
            graph.instantiate()
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            sp.note(nodes=nodes)
        self._delta = {k: _cuda.launch_counts[k] - before[k] for k in _cuda.launch_counts}
        self._graph = graph
        self.stats = dict(name=self.name, capture_s=t1 - t0, instantiate_s=t2 - t1, nodes=nodes,
                          pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
                          launches={k: n for k, n in self._delta.items() if n},
                          warm_s=warm_s, epochs=self.epochs)


def run(key: tuple, fn, *args, warm=None):
    """Call the program cached under ``key`` and the inputs' structure,
    shapes, dtypes, devices and None-ness (a missing mask is another program),
    making it from ``fn`` on the first call: the static arguments that
    ``jax.jit`` takes as ``static_argnames`` belong in ``key``.  ``key[0]``
    names the program's family: the first capture of a family in a process
    warms up first, with ``warm`` (a shorter run of the same operations on
    the same inputs) where given.  A ``train_epochs`` key holds the epochs a
    call runs at ``key[3]`` (``registration/optimizer.py``).  Returns the
    program's static outputs (see the module's docstring)."""
    leaves: list = []
    spec = _flatten(args, leaves)
    full = (key, _signature(spec, leaves))
    prog = _cache.get(full)
    if prog is None:
        epochs = key[3] if key[0] == "train_epochs" else None
        prog = _cache[full] = Program(fn, str(key[0]), warm=warm, epochs=epochs)
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
            counters["evictions"] += 1
    else:
        _cache.move_to_end(full)
    return prog(*args)


def clear() -> None:
    """Drop every cached program (their graphs and memory pools)."""
    _cache.clear()


def clone(tree):
    """A copy of a tree of tensors that outlives the program's next call."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([None if t is None else t.clone() for t in leaves]))
