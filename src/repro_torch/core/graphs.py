"""CUDA-graph capture of the port's compiled programs.

The reference compiles each of its hot programs once per key and launches
it as one XLA executable: the offload dispatch (``OffloadRuntime._build``,
``jax.jit(shard_map(program))`` cached per plan key), the decode step and
the serve step, the decode chunk (one ``lax.scan`` of ``decode_chunk``
steps: one launch per chunk, the paper's job-granularity knob) and the
ragged continuous-batching step.  On the card the port runs the same eager
bodies as captured CUDA graphs (``torch.cuda.CUDAGraph``): a body runs
once eagerly on a side stream (the warm-up a capture asks for, and that
call's own work), is captured once on a stream of its own, and every
later call with the same key replays it — one host call for the whole
program instead of one per device op.

A body captured here reads and writes only tensors bound to it when it was
built (the graph's fixed addresses) and reads no tensor value on the host,
so one capture serves every later call.  Its outputs are the graph's
static buffers, which the next replay rewrites: a call with
``copy=True`` returns copies made on the launch stream, which the caller
may keep.

Captured, on the card:

* the resident offload dispatch (``core/offload.py``): a plan's
  ``_Program`` on its resident buffers and its cached job-args buffer,
  keyed like ``OffloadRuntime._build``;
* the serve engine's decode programs (``serve/engine.py``): the sampling
  step, the decode chunk, the ``host`` mode's serve step and the ragged
  step, keyed by (mode, batch, max_len, chunk, temperature).  Every family
  the port builds captures the same way: the dense KV cache, the ssm
  family's state (``conv``, ``h``) and the hybrid's state with its shared
  block's K/V slots all stay at fixed addresses, and the hybrid's choice
  of the layers the shared block follows is made on the static layer
  index, not on a device value.

Eager, everywhere: prefill (its shapes follow the prompt, and its time is
the device's), every dispatch that stages fresh operands (cold and warm
offloads, ``OffloadStream``'s and ``submit_graph``'s staged submits:
their time is staging), and plans whose config donates operands.  On the
CPU every body runs eagerly: the caller asked for the CPU.

Launch counts: a kernel's wrapper adds one to ``build.KERNELS[*].launches``
where it launches.  During a capture it launches nothing, so the counts
that capture added are taken back, and every replay adds them, so the
counts are device launches.

A capture (its warm-up and instantiation included) is the span
``graphs.capture`` (``core/trace.py``).  A capture or a replay that fails
raises; nothing here retries eagerly.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, Dict, Hashable, Iterator, Optional, \
    Sequence

import torch

from repro_torch.core import trace
from repro_torch.kernels import build

Body = Callable[[], Any]


def captures(device: torch.device) -> bool:
    """Whether programs on ``device`` run as captured graphs: on the card."""
    return torch.device(device).type == "cuda"


def _tensors(out: Any) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _clone(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(o) for o in out)
    return out


class Graph:
    """One body: run and captured at its first call, replayed after.

    ``bound`` are the tensors the body reads and writes (kept alive with
    the graph, and compared by identity when the cache is asked for the
    graph again); ``generators`` the ``torch.Generator``s it draws from,
    registered with the graph so a replay draws what an eager call would.
    """

    def __init__(self, body: Body, *, bound: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.bound = tuple(bound)
        self.generators = tuple(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        #: kernel launches a replay makes, by kernel name
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0       # warm-up, capture and instantiation
        self.pool_bytes = 0        # device memory the graph's pool holds
        self.replays = 0

    def __call__(self, copy: bool = False) -> Any:
        """Run the program once: its first call runs the body eagerly and
        captures it; later calls replay.  With ``copy``, a replay returns
        copies of the static outputs."""
        if self.graph is None:
            with trace.span("graphs.capture"):
                return self._capture()
        self.graph.replay()
        for name, n in self.launches.items():
            build.KERNELS[name].launches += n
        self.replays += 1
        return _clone(self.out) if copy else self.out

    def _capture(self) -> Any:
        t0 = time.perf_counter()
        launch = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(launch)
        with torch.cuda.stream(side):
            out = self.body()           # the warm-up is this call's run
        launch.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(launch)
        torch.cuda.synchronize()
        # the capture allocates only from the graph's own pool, so what
        # the caching allocator reserves meanwhile is that pool.  Unlike
        # ``torch.cuda.graph`` this leaves the device and pinned-host
        # caches as they are: emptying them costs every later dispatch
        # that allocates (a result's pinned fetch buffer) a fresh
        # cudaMalloc / cudaHostAlloc
        reserved = torch.cuda.memory_reserved()
        counts = build.launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin()
            try:
                self.out = self.body()
            finally:
                graph.capture_end()
        graph.instantiate()
        after = build.launch_counts()
        self.launches = {k: after[k] - counts[k] for k in after
                         if after[k] != counts[k]}
        for k, n in counts.items():
            build.KERNELS[k].launches = n
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return out


def capture(body: Body, *, bound: Sequence[torch.Tensor] = (),
            generators: Sequence[torch.Generator] = ()) -> Graph:
    """The graph of ``body``, captured at its first call."""
    return Graph(body, bound=bound, generators=generators)


class GraphCache:
    """The captured programs of one owner (a runtime, an engine), by key.

    :meth:`run` runs the program under ``key``: eagerly off the card; on
    the card through its graph, captured at the first call of the key and
    replayed by every later one.  An entry whose bound tensors are not the
    ones a call binds is captured again; :meth:`drop` forgets one (its
    owner drops it when the tensors it reads are replaced or freed).
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, Graph] = {}

    def run(self, key: Hashable, make_body: Callable[[], Body], *,
            bound: Sequence[torch.Tensor] = (),
            generators: Sequence[torch.Generator] = (),
            copy: bool = False) -> Any:
        """``make_body()`` run once: eagerly off the card, or as the graph
        under ``key``.  ``make_body`` is called only when a body is needed
        (every call off the card, a capture on it); with ``copy`` a replay
        returns copies of its outputs."""
        if not captures(self.device):
            return make_body()()
        g = self._graphs.get(key)
        if g is not None and (len(g.bound) != len(bound) or any(
                a is not b for a, b in zip(g.bound, bound))):
            g = None
        if g is None:
            g = capture(make_body(), bound=bound, generators=generators)
            self._graphs[key] = g
        return g(copy=copy)

    def drop(self, key: Hashable) -> None:
        self._graphs.pop(key, None)

    def get(self, key: Hashable) -> Optional[Graph]:
        return self._graphs.get(key)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self):
        return self._graphs.keys()


# -- what a graph holds: its nodes, read through libcuda --------------------

#: CUgraphNodeType values (cuda.h) the census names
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
              10: "mem_alloc", 11: "mem_free", 13: "conditional"}


def _libcuda():
    """(libcuda, its dependency query as ``deps(node, array, &count)``):
    ``cuGraphNodeGetDependencies_v2`` (CUDA 12.3 on) with its edge data
    left out; the card's CUDA driver refused the unversioned entry
    point's three-argument call (error 1)."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    cu.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), sz]
    cu.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    get = cu.cuGraphNodeGetDependencies_v2
    get.argtypes = [vp, ctypes.POINTER(vp), vp, sz]
    for fn in (cu.cuGraphGetNodes, cu.cuGraphNodeGetType, get):
        fn.restype = ctypes.c_int
    return cu, lambda node, out, count: get(node, out, None, count)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA driver error {rc}")


def census(graph: Graph) -> Dict[str, int]:
    """The nodes of a captured graph by kind, their count, and the
    longest chain of dependent nodes in it (``depth``), read from the
    CUDA driver library (``cuGraphGetNodes``)."""
    if graph.graph is None:
        raise RuntimeError("the graph has not been captured yet")
    cu, deps_of = _libcuda()
    g = ctypes.c_void_p(graph.graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    index = {nodes[i]: i for i in range(n.value)}
    counts: Dict[str, int] = {"nodes": n.value}
    deps = []
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(nodes[i], ctypes.byref(kind)),
               "cuGraphNodeGetType")
        name = NODE_KINDS.get(kind.value, f"type{kind.value}")
        counts[name] = counts.get(name, 0) + 1
        k = ctypes.c_size_t(0)
        _check(deps_of(nodes[i], None, ctypes.byref(k)),
               "cuGraphNodeGetDependencies")
        got = (ctypes.c_void_p * max(k.value, 1))()
        if k.value:
            _check(deps_of(nodes[i], got, ctypes.byref(k)),
                   "cuGraphNodeGetDependencies")
        deps.append([index[got[j]] for j in range(k.value)])
    depth = [0] * n.value
    for start in range(n.value):          # iterative longest path
        stack = [start]
        while stack:
            i = stack[-1]
            if depth[i]:
                stack.pop()
                continue
            todo = [d for d in deps[i] if not depth[d]]
            if todo:
                stack.extend(todo)
                continue
            depth[i] = 1 + max((depth[d] for d in deps[i]), default=0)
            stack.pop()
    counts["depth"] = max(depth, default=0)
    return counts
