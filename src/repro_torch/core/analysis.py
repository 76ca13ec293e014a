"""Trace analysis: collective wire bytes and structural overlap (port of
``repro/core/analysis.py``).

The reference parses the HLO that XLA lowers for 512 placeholder devices.
The port has no compiler in between: it records ONE rank's program as it
runs, op by op, on ``meta`` tensors (shapes without data), with a
``TorchDispatchMode`` (``Tracer``).  Every aten op and every ``c10d``
collective becomes a ``Node`` of a dataflow graph: its inputs are the
current versions of the tensors it reads, and a tensor it writes in place
(a cache update, an in-place all-reduce) gets a new version made by it.
Versions are kept per storage, so a write to a view versions the whole
buffer (a conservative edge, never a missing one).  View ops move no data
and make no node.

From the trace:

  * ``parse_collectives``: counts, buffer bytes and per-device wire bytes of
    the collectives, with the reference's ring factors, from the ``c10d``
    ops and the size of the process group each ran on;
  * ``overlap_metric``: the reference's definition on the traced graph, for
    each collective the dot ops (``aten.mm/bmm/addmm/baddbmm``) that are
    neither its ancestors nor its descendants (work it could hide behind),
    averaged.  Baseline TP prefill has ~0 per collective; ISO about one
    chunk's worth.  The reference's ``overlap_metric_stablehlo`` (lowered
    MLIR) and ``overlap_metric`` (compiled HLO) both map to this function;
  * ``Trace.flops``: 2 m n k per matmul (the reference's XLA
    ``cost_analysis`` also counts elementwise and transcendental ops);
    ``Trace.bytes``: the bytes each op reads plus writes, summed (XLA's
    ``bytes accessed`` counts per fused kernel, so it is lower wherever
    XLA fuses); ``Trace.peak_temp_bytes``: the peak of the storage the
    program allocated and still holds (XLA's ``temp_size`` is its buffer
    assignment's, which reuses memory more tightly).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> collective kind; the first argument of each holds the result
# buffer(s) whose bytes the reference's HLO type gives: the reduced tensors
# (all-reduce, in place), the gathered output, the scattered output, the
# exchanged output, the sent tensors
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}
DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")
# ops that allocate without writing
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` over ``n`` ranks
    whose result buffer holds ``nbytes`` (the reference's ring factors)."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if kind == "all-gather":
        return (n - 1) / n * nbytes              # nbytes = gathered result
    if kind == "reduce-scatter":
        return (n - 1) * nbytes                  # nbytes = scattered result
    if kind == "all-to-all":
        return (n - 1) / n * nbytes
    return nbytes                                # collective-permute


@dataclass
class Node:
    op: str                      # e.g. "aten.mm.default"
    kind: str                    # "dot", a COLLECTIVES kind, or "other"
    preds: List[int]
    flops: float = 0.0
    bytes: int = 0
    coll_bytes: int = 0          # a collective's result buffer
    group: int = 0               # a collective's group size


@dataclass
class Trace:
    nodes: List[Node] = field(default_factory=list)
    peak_temp_bytes: int = 0

    @property
    def flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    @property
    def bytes(self) -> int:
        return sum(n.bytes for n in self.nodes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _dot_flops(name: str, args) -> float:
    """2 m n k of a matmul: mm (m,k)@(k,n), addmm (bias, a, b), bmm and
    baddbmm batched."""
    a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1],
                                                            args[2])
    k = a.shape[-1]
    return 2.0 * a.numel() / k * b.shape[-1] * k


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().name() == "ProcessGroup":
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


class Tracer(TorchDispatchMode):
    """Records every op run under it into ``self.trace`` (see module doc).
    Meant for meta tensors: it reads no data.  Use as a context manager;
    storages allocated inside are tracked for ``peak_temp_bytes`` until the
    mode exits."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        self._version: Dict[int, int] = {}
        self._tracked = set()
        self._live = 0
        self._finalizers: List[weakref.finalize] = []

    def __exit__(self, *exc):
        for f in self._finalizers:
            f.detach()
        self._finalizers = []
        return super().__exit__(*exc)

    def _free(self, key: int, nbytes: int) -> None:
        self._live -= nbytes
        self._version.pop(key, None)
        self._tracked.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        if schema.returns and all(r.alias_info is not None and
                                  not r.alias_info.is_write
                                  for r in schema.returns):
            return out                           # a view: no data moves
        name = func.overloadpacket.__name__
        ns = func.namespace
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                written += [t for t in tree_leaves(val)
                            if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        idx = len(self.trace.nodes)
        preds = sorted({self._version[k] for k in map(_key, inputs)
                        if k in self._version})
        node = Node(op=str(func), kind="other", preds=preds)
        if ns == "c10d":
            kind = _C10D.get(name)
            if kind is not None:
                node.kind = kind
                node.coll_bytes = sum(_nbytes(t) for t in tree_leaves(args[0])
                                      if isinstance(t, torch.Tensor))
                node.group = _group_size(args)
        elif ns == "aten" and name in DOT_OPS:
            node.kind = "dot"
            node.flops = _dot_flops(name, args)
        if name not in _UNWRITTEN:
            node.bytes = sum(map(_nbytes, inputs)) + \
                sum(map(_nbytes, outs if not written else written))
        self.trace.nodes.append(node)
        written_keys = {_key(t) for t in written}
        for t in written + outs:
            k = _key(t)
            if k not in self._tracked:
                # a storage this op allocated is held until it is freed; a
                # caller's buffer written in place is only versioned
                st = t.untyped_storage()
                nb = 0 if k in written_keys else st.nbytes()
                self._live += nb
                self._tracked.add(k)
                self._finalizers.append(weakref.finalize(st, self._free, k,
                                                         nb))
            self._version[k] = idx
        self.trace.peak_temp_bytes = max(self.trace.peak_temp_bytes,
                                         self._live)
        return out


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    buffer_bytes: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    wire_bytes: float = 0.0

    def total_count(self) -> int:
        return sum(self.counts.values())


def parse_collectives(trace: Trace) -> CollectiveStats:
    """Per-device wire bytes of the traced collectives, ring factors."""
    st = CollectiveStats()
    for n in trace.nodes:
        if n.kind not in COLLECTIVES:
            continue
        st.counts[n.kind] += 1
        st.buffer_bytes[n.kind] += n.coll_bytes
        st.wire_bytes += wire_bytes(n.kind, n.coll_bytes, n.group)
    return st


def _closures(nodes: List[Node], order, neighbours, keep) -> Dict[int, int]:
    """For each node in ``keep``: the bitset (over dot indices) of the dots
    reachable from it through ``neighbours`` (preds: ancestors; succs:
    descendants), walking ``order`` so each node's neighbours come first.
    A node's set is dropped once every node that needs it is done."""
    dot_bit = {}
    for i, n in enumerate(nodes):
        if n.kind == "dot":
            dot_bit[i] = 1 << len(dot_bit)
    users = [0] * len(nodes)
    for i in order:
        for j in neighbours[i]:
            users[j] += 1
    sets: Dict[int, int] = {}
    out = {}
    for i in order:
        s = 0
        for j in neighbours[i]:
            s |= sets[j] | dot_bit.get(j, 0)
            users[j] -= 1
            if users[j] == 0:
                del sets[j]
        sets[i] = s
        if i in keep:
            out[i] = s
        if users[i] == 0:
            del sets[i]
    return out


def overlap_metric(trace: Trace) -> Dict[str, Any]:
    """For every collective: the dot ops that are dataflow-independent of
    it (hideable), averaged, and that average over all dots.  The trace is
    one graph, so ``computation`` (the reference's busiest HLO computation)
    is always ``"trace"``."""
    nodes = trace.nodes
    colls = [i for i, n in enumerate(nodes) if n.kind in COLLECTIVES]
    if not colls:
        return {"collectives": 0, "avg_hideable_dots": 0.0,
                "hideable_fraction": 0.0}
    preds = [n.preds for n in nodes]
    succs: List[List[int]] = [[] for _ in nodes]
    for i, ps in enumerate(preds):
        for p in ps:
            succs[p].append(i)
    keep = set(colls)
    n = len(nodes)
    anc = _closures(nodes, range(n), preds, keep)
    desc = _closures(nodes, range(n - 1, -1, -1), succs, keep)
    total = sum(1 for x in nodes if x.kind == "dot")
    counts = [total - (anc[c] | desc[c]).bit_count() for c in colls]
    avg = sum(counts) / len(counts)
    return {"collectives": len(colls), "avg_hideable_dots": avg,
            "hideable_fraction": avg / max(total, 1),
            "computation": "trace", "total_dots": total}


def trace_program(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``Tracer``: (its result, the
    trace)."""
    with Tracer() as tr:
        out = fn(*args, **kwargs)
    return out, tr.trace
