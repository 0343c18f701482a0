"""FX -> Chakra conversion (Flint's Graph Converter, paper SS4.3).

Counterpart of ``src/repro/core/convert.py::hlo_to_chakra``. It walks a
graph that ``make_fx`` traced on fake tensors (``core/capture.py``), in
program order, and emits a Chakra graph whose edges are true data
dependencies:

  * one COMP node per aten op and per kernel operator
    (``torch.ops.repro_torch.*``, one node per kernel call), with ``flops``
    from PyTorch's flop registry (the formulas ``FlopCounterMode`` uses,
    and those the kernel modules register), ``bytes`` (each distinct input
    read once, each output written once) and ``out_bytes``;
  * one COMM_COLL node per ``_c10d_functional`` collective, with the attrs
    the JAX converter sets;
  * no node for what launches nothing on the card: placeholders,
    constants, views (any op whose schema says its output aliases an input,
    e.g. view, permute, unsqueeze, expand, t, detach, slice), allocations
    (``empty``) and ``wait_tensor``. Their dependencies are forwarded, as
    the JAX converter forwards tuple and bitcast.

The trace is not functionalized: the train step writes ``.grad`` through
``loss.backward()`` and AdamW updates params and moments in place. So the
walk keeps, for each storage, the node that last wrote it: a node depends
on the last writer of every storage it reads (a view reads its base's
storage), and an op that mutates an input becomes that storage's new last
writer. A reader after an in-place update thus depends on the update, and
the update on what it read.
"""
from __future__ import annotations

import math
import operator
from typing import Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core import chakra

aten = torch.ops.aten
c10d = torch.ops._c10d_functional

# ops that launch nothing besides the views (OpOverload.is_view): a view
# of a fresh tensor, the lift of a constant, and allocations (storage that
# no one wrote yet)
_NO_KERNEL = {aten._unsafe_view.default, aten._reshape_alias.default,
              aten.lift_fresh_copy.default, aten.lift_fresh.default,
              aten.empty.memory_format, aten.empty_strided.default,
              aten.empty_like.default, aten.new_empty.default,
              aten.new_empty_strided.default}
# ops that overwrite their first argument without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}
_COLLECTIVES = {
    c10d.all_reduce.default: "all-reduce",
    c10d.all_gather_into_tensor.default: "all-gather",
    c10d.reduce_scatter_tensor.default: "reduce-scatter",
    c10d.all_to_all_single.default: "all-to-all",
}
_WAIT = c10d.wait_tensor.default


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: an expanded
    dimension (stride 0) counts once."""
    if t.numel() == 0:
        return 0
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _group(group_name: str):
    """(ranks of the group, number of such groups in the world)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    return ranks, dist.get_world_size() // len(ranks)


def node_flops(target, args, kwargs, out) -> int:
    """What ``FlopCounterMode`` counts for one call of ``target``: its flop
    registry formula (0 for an op that has none)."""
    formula = flop_registry.get(getattr(target, "overloadpacket", None))
    return int(formula(*args, **kwargs, out_val=out)) if formula else 0


class _Builder:
    def __init__(self, graph: chakra.Graph):
        self.g = graph
        self.writer: Dict[int, List[int]] = {}   # storage -> its last writers' ids

    def deps_of(self, tensors) -> List[int]:
        out: List[int] = []
        for t in tensors:
            out.extend(self.writer.get(_storage(t), ()))
        return list(dict.fromkeys(out))

    def node(self, fx_node):
        target = fx_node.target
        if target is operator.getitem:
            return                     # one output of a node already emitted
        if not isinstance(target, torch._ops.OpOverload):
            raise ValueError(f"fx_to_chakra: unexpected call of {target}")
        args, kwargs = _vals(fx_node.args), _vals(fx_node.kwargs)
        out = fx_node.meta.get("val")
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if target.is_view or target in _NO_KERNEL:
            return
        deps = self.deps_of(ins)
        if target == _WAIT:
            for t in outs:
                self.writer[_storage(t)] = deps
            return
        if target in _COLLECTIVES:
            nid = self._collective(fx_node, target, args, ins, outs, deps)
        else:
            nid = self._comp(fx_node, target, args, kwargs, ins, outs, out, deps)
        for t in outs + _mutated(target, fx_node):   # fresh outputs, mutated inputs
            self.writer[_storage(t)] = [nid]

    def _comp(self, fx_node, target, args, kwargs, ins, outs, out, deps) -> int:
        read = ins[1:] if target in _WRITE_ONLY else ins
        in_bytes = sum(tensor_bytes(t) for t in _distinct(read))
        out_bytes = sum(tensor_bytes(t) for t in outs)
        return self.g.add(fx_node.name, chakra.COMP, deps=deps,
                          flops=float(node_flops(target, args, kwargs, out)),
                          bytes=float(in_bytes + out_bytes), out_bytes=float(out_bytes),
                          op=str(target))

    def _collective(self, fx_node, target, args, ins, outs, deps) -> int:
        kind = _COLLECTIVES[target]
        ranks, n_groups = _group(args[-1])
        in_bytes = sum(tensor_bytes(t) for t in ins)
        out_bytes = sum(tensor_bytes(t) for t in outs)
        # comm_bytes: the per-device payload; all-gather's operand is the shard
        payload = float(out_bytes if kind == "all-gather" else in_bytes)
        return self.g.add(fx_node.name, chakra.COMM_COLL, deps=deps, comm_kind=kind,
                          comm_bytes=payload, in_bytes=float(in_bytes),
                          out_bytes=float(out_bytes), group_size=len(ranks),
                          n_groups=n_groups, group=list(ranks), op=str(target))


def _mutated(target, fx_node) -> List[torch.Tensor]:
    """The tensors that ``target`` writes in place, by its schema."""
    out = []
    for i, arg in enumerate(target._schema.arguments):
        if arg.alias_info is not None and arg.alias_info.is_write:
            val = fx_node.kwargs.get(arg.name) if arg.kwarg_only or i >= len(fx_node.args) \
                else fx_node.args[i]
            out += _tensors(_vals(val))
    return out


def _distinct(tensors):
    seen, out = set(), []
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _vals(tree):
    """An FX node's args with each input node replaced by its traced value."""
    return torch.fx.node.map_arg(tree, lambda n: n.meta.get("val"))


def fx_to_chakra(gm: torch.fx.GraphModule, meta: Optional[dict] = None) -> chakra.Graph:
    """The Chakra graph of ``gm``, a graph traced by ``make_fx`` whose nodes
    carry their fake outputs in ``meta["val"]``."""
    g = chakra.Graph(meta={"source": "flint-torch", **(meta or {})})
    b = _Builder(g)
    for fx_node in gm.graph.nodes:
        if fx_node.op == "call_function":
            b.node(fx_node)
        elif fx_node.op not in ("placeholder", "get_attr", "output"):
            raise ValueError(f"fx_to_chakra: unexpected node {fx_node.op} {fx_node.target}")
    return g
