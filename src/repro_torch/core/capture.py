"""Cluster-free workload capture (Flint's runtime, paper SS4).

Counterpart of ``src/repro/core/capture.py``. Where the JAX package lowers
a jitted step on ShapeDtypeStructs, ``capture_step`` traces a step of the
port with ``make_fx`` on fake tensors: every tensor has a shape, a dtype
and a device but no memory, no kernel is launched and nothing is built,
so a step of any width and depth traces on a ``cuda`` device whether or not
a card is present. The trace runs the step's Python as the card would:
``loss.backward()``, remat's recomputation in the backward and AdamW's
in-place updates all appear in it. Each of the port's kernels, K1, K2 and
K3 and their backwards, is one operator (``torch.ops.repro_torch.*``) and
so one node. ``core/convert.py`` turns the trace into a Chakra graph.

Typical use, with no card::

    with fake_mode():
        model = Model(cfg, abstract=True)                    # cuda, fake
        tokens = torch.empty(B, S, dtype=torch.long, device="cuda")
        cap = capture_step(make_forward_step(model), (tokens,))
    cap.graph.save("g.json")                  # repro.core.chakra reads it

A ``cuda`` trace needs a build of PyTorch with CUDA, though no card
(``Model(..., abstract=True)`` says why); on a build without, trace on ``cpu``: the
graph holds the same kernel nodes.

A step under a mesh is captured as one rank's program
(``capture_sharded_step``): under a fake process group
(``parallel.mesh.fake_process_group``) the trace takes the rank's local
shards of the parameters and inputs and wraps them as DTensors inside the
step, so its nodes are the rank's products at local shapes and the
collectives between ranks; a train step's graph also holds the rank's
backward and its AdamW on its shards. ``capture_step`` refuses DTensor
arguments: a trace over them is the global program, whose FLOPs are those
of all ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter
from typing import Dict, Optional
from unittest import mock

import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.fx.experimental import proxy_tensor
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.core import chakra
from repro_torch.core.convert import fx_to_chakra

KERNEL_NAMESPACE = "repro_torch"


@dataclasses.dataclass
class CaptureResult:
    meta: Dict
    graph_text: str                     # the traced FX graph as Python
    summary: Dict                       # totals over the graph (see summarize)
    graph: chakra.Graph


class _DeviceFreeFakeMode(FakeTensorMode):
    """A FakeTensorMode that leaves the device alone even where a card is
    present: the plain mode does so only where it finds no card, and with
    one it computes a small constant moved to the card (AdamW's bias
    corrections) for real, there. (It still makes one 4-byte tensor per
    device name, once a process, to ready CUDA for a fake backward.)"""

    @property
    def avoid_device_init(self) -> bool:
        return True


def fake_mode() -> FakeTensorMode:
    """The mode to make a capture's model and inputs in: every tensor made
    inside it is fake, and nothing in it allocates on or runs on a
    device."""
    return _DeviceFreeFakeMode()


def summarize(graph: chakra.Graph) -> Dict:
    """Totals of a captured graph, under the JAX summary's names where the
    quantity is the same: ``parsed_flops`` (what ``FlopCounterMode`` counts
    over the step), ``parsed_hbm_bytes`` (each op's inputs read once and
    outputs written once, op by op, as the eager card run reads and writes
    them; XLA's count is over fused ops, so it is smaller for the same
    step), ``comm`` / ``comm_bytes`` / ``collectives``, and
    ``kernel_nodes``, the nodes of each of the port's kernel operators."""
    comm: Dict[str, Dict] = {}
    colls = []
    for n in graph.by_type(chakra.COMM_COLL):
        c = comm.setdefault(n.attrs["comm_kind"], {"count": 0, "bytes": 0.0})
        c["count"] += 1
        c["bytes"] += n.attrs["comm_bytes"]
        colls.append({"name": n.name, "kind": n.attrs["comm_kind"],
                      "bytes": n.attrs["comm_bytes"], "group": n.attrs["group"]})
    comps = graph.by_type(chakra.COMP)
    kernels = Counter(n.attrs["op"].split(".")[1] for n in comps
                      if n.attrs["op"].startswith(KERNEL_NAMESPACE + "."))
    return {"parsed_flops": sum(n.attrs["flops"] for n in comps),
            "parsed_hbm_bytes": sum(n.attrs["bytes"] for n in comps),
            "comm": comm,
            "comm_bytes": sum(c["bytes"] for c in comm.values()),
            "collectives": colls,
            "kernel_nodes": dict(sorted(kernels.items())),
            "n_nodes": len(graph)}


def capture_step(step_fn, example_args, meta: Optional[Dict] = None) -> CaptureResult:
    """Trace ``step_fn(*example_args)`` on fake tensors and convert it into a
    Chakra graph and its summary. ``example_args`` (and the model the step
    closes over) are made inside ``fake_mode()``: nothing is allocated on a
    device and nothing runs there. The meta records the trace's and the
    conversion's seconds."""
    if any(isinstance(x, DTensor) for x in tree_flatten(example_args)[0]):
        raise ValueError("capture_step traces local tensors: a trace over DTensor "
                         "arguments counts the FLOPs of every rank; capture a sharded "
                         "step with capture_sharded_step")
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        # make_fx computes an op on one-element constants for real, on their
        # device (a bias correction moved to the card: an allocation there
        # and a kernel for each op on it, ~1,000 a training step on an H100);
        # with no such constants the fake mode's own, kept on the host, serve
        # float()
        stack.enter_context(mock.patch.object(proxy_tensor, "CONSTANT_NUMEL_LIMIT", 0))
        # selective checkpointing (remat dots) takes make_fx's proxy mode for
        # a compiler's: it keeps every output and leaves the recompute to the
        # compiler's partitioner, so the trace would hold none. Told that no
        # compiler traces, it runs as eagerly on the card: the backward
        # recomputes what the policy does not save (K1's forward among them)
        if hasattr(torch_checkpoint, "_is_compiling"):
            stack.enter_context(mock.patch.object(torch_checkpoint, "_is_compiling",
                                                  lambda *a, **k: False))
        gm = make_fx(step_fn, tracing_mode="fake")(*example_args)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = fx_to_chakra(gm, meta)
    t_convert = time.perf_counter() - t0
    meta = dict(meta or {})
    meta.update({"t_trace_s": t_trace, "t_convert_s": t_convert,
                 "fx_nodes": len(gm.graph.nodes)})
    graph.meta.update(meta)
    return CaptureResult(meta=meta, graph_text=gm.code, summary=summarize(graph),
                         graph=graph)


def capture_sharded_step(step_fn, model, inputs, meta: Optional[Dict] = None) -> CaptureResult:
    """One rank's program of ``step_fn(*inputs)``, a step made under a mesh
    (``mesh=``) over ``model`` sharded by ``parallel.sharding.shard_model``,
    with ``inputs`` DTensors (``shard_inputs``), all made in ``fake_mode()``
    under a fake process group. The trace takes the rank's local shards of
    the parameters and inputs and wraps them back into DTensors inside the
    step, each parameter keeping its ``requires_grad``; what the step
    returns is taken local. A train step's ``TrainState`` is an input like
    any other: its params, the model's own, are traced as the model's
    wrapped parameters, and its moments as the rank's shards, so the graph
    holds the rank's forward, backward and AdamW with the gradients'
    collectives. The meta records the world size."""
    params = [(mod, key, p) for mod in model.modules()
              for key, p in mod._parameters.items() if isinstance(p, DTensor)]
    if not params:
        raise ValueError("the model has no DTensor parameters: shard it first")
    index = {id(p): i for i, (_, _, p) in enumerate(params)}

    def wrap(local, like):
        return DTensor.from_local(local, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape, stride=like.stride())

    leaves, spec = tree_flatten(tuple(inputs))

    def rank_step(param_locals, input_locals):
        wrapped = [nn.Parameter(wrap(local, p), requires_grad=p.requires_grad)
                   for (_, _, p), local in zip(params, param_locals)]
        for (mod, key, _), w in zip(params, wrapped):
            mod._parameters[key] = w
        try:
            out = step_fn(*tree_unflatten(
                [wrapped[index[id(like)]] if id(like) in index
                 else wrap(x, like) if isinstance(like, DTensor) else x
                 for x, like in zip(input_locals, leaves)], spec))
        finally:
            for mod, key, p in params:
                mod._parameters[key] = p
        return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, out)

    meta = dict(meta or {})
    meta["world_size"] = dist.get_world_size()
    # a parameter among the inputs is traced once, as the model's
    return capture_step(rank_step, ([p.to_local().detach() for _, _, p in params],
                                    [None if id(x) in index
                                     else x.to_local().detach() if isinstance(x, DTensor) else x
                                     for x in leaves]), meta)
