"""CUDA graphs of layers whose shapes are fixed, captured once and replayed.

A frame-at-a-time stream runs the same layers at the same shapes on every
frame, and on the card their hundreds of small launches a frame keep the
device waiting on the host. `LayerGraphs` holds one CUDA graph per layer
and call signature. `graphed(graphs, name, fn, *args)` is `fn(*args)` where
`graphs` is None. Otherwise, for a key made of `name` and the arguments
(each tensor's shape, dtype, strides and device, or the place where the
same tensor came before; every other argument's value):

- the first call runs `fn(*args)` as it is and returns its result, then
  captures the same call as a graph, on static copies of the tensors in
  `args`, on a side stream and into a memory pool that the object's graphs
  share;
- every later call copies the tensors of `args` into the static copies,
  replays the graph on the current stream, and returns copies of its
  outputs, so that no tensor that the caller keeps aliases the graph's
  memory, which the next replay writes again.

`fn` must compute its outputs from its arguments alone, with no wait for
the device and no other stream inside. Its parameters are read where they
were at capture: weights updated in place show in the next replay, but
parameters replaced by other tensors would leave the graph reading freed
memory, so whoever replaces them drops the graphs first.

The graphs run one at a time, in the order of their calls, on one stream,
so that the temporaries they share in the pool never overlap in time.
Each replay adds to `ops._kernels.LAUNCHES` the launches of each
hand-written kernel that its capture counted (the capture itself counts
none), so that a replayed call counts what an eager one counts.
`captures` and `replays` count the graphs captured and replayed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..ops import _kernels


def _key(name: str, leaves: List[Any]) -> tuple:
    """The call's key; a tensor passed twice is keyed by its first place,
    so that its static copy is shared as the tensor is."""
    first: Dict[int, int] = {}
    key: List[Any] = [name]
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            j = first.setdefault(id(x), i)
            key.append((tuple(x.shape), x.dtype, x.stride(), x.device)
                       if j == i else ("same as", j))
        else:
            key.append(x)
    return tuple(key)


class _Graph:
    """One captured call: its static inputs and outputs, and the kernel
    launches it makes."""

    def __init__(self, fn, leaves: List[Any], spec, pool, stream):
        static: Dict[int, torch.Tensor] = {}
        self.inputs: List[Any] = []
        # the place of each distinct tensor, copied in before each replay
        self.copied: List[int] = []
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor):
                if id(x) not in static:
                    static[id(x)] = torch.empty_like(x).copy_(x)
                    self.copied.append(i)
                x = static[id(x)]
            self.inputs.append(x)
        before = _kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                out = fn(*pytree.tree_unflatten(self.inputs, spec))
            self.launches = {k: n - before[k] for k, n in
                             _kernels.LAUNCHES.items() if n != before[k]}
        finally:
            _kernels.LAUNCHES.update(before)
        self.outputs, self.out_spec = pytree.tree_flatten(out)

    def replay(self, leaves: List[Any]):
        for i in self.copied:
            self.inputs[i].copy_(leaves[i])
        self.graph.replay()
        for k, n in self.launches.items():
            _kernels.LAUNCHES[k] += n
        return pytree.tree_unflatten(
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in self.outputs], self.out_spec)


class LayerGraphs:
    """The CUDA graphs of one device's fixed-shape layers (module
    docstring)."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0

    def run(self, name: str, fn, *args):
        leaves, spec = pytree.tree_flatten(args)
        key = _key(name, leaves)
        g = self._graphs.get(key)
        if g is None:
            out = fn(*args)
            self._graphs[key] = _Graph(fn, leaves, spec, self.pool,
                                       self.stream)
            self.captures += 1
            return out
        self.replays += 1
        return g.replay(leaves)


def graphed(graphs: Optional[LayerGraphs], name: str, fn, *args):
    """fn(*args), replayed from `graphs` where it is given."""
    return fn(*args) if graphs is None else graphs.run(name, fn, *args)
