"""What device work one call enqueues, read from a CUDA graph.

``chip_smoke.py`` and the ``cuda`` tests use `graph_nodes` to show that a
wrapper launches one kernel a call and nothing else (K6: no combine
kernel, no partial buffers to fill).  The call is captured into a CUDA
graph and the graph's nodes are read through the driver, so the count is
exact: `torch.profiler`'s device records come from CUPTI's activity
buffers, which lose records now and then (most often in the seconds after
a long profiled run), and a trace then shows fewer kernels than ran.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

# CUgraphNodeType (cuda.h), by value
NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def _driver(fn_name: str) -> Callable[..., int]:
    fn = getattr(ctypes.CDLL("libcuda.so.1"), fn_name)

    def call(*args) -> None:
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{fn_name} failed with CUresult {err}")
    return call


def graph_nodes(fn: Callable[[], object]) -> list[str]:
    """Kinds of the device work that one call of ``fn`` enqueues on the
    current device, one entry a graph node (``"kernel"``, ``"memset"``,
    ...): the call is captured into a CUDA graph, its nodes are listed, and
    the graph is replayed once, so the captured work runs.  ``fn`` must be
    safe to capture (no host synchronisation)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _driver("cuGraphGetNodes")(handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    _driver("cuGraphGetNodes")(handle, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        _driver("cuGraphNodeGetType")(ctypes.c_void_p(node),
                                      ctypes.byref(kind))
        kinds.append(NODE_KINDS[kind.value] if 0 <= kind.value
                     < len(NODE_KINDS) else f"type {kind.value}")
    graph.replay()
    torch.cuda.synchronize()
    graph.reset()
    return kinds
