"""Chakra-style workload graph (the paper's interchange format).

The port's own copy of ``src/repro/core/chakra.py``, line for line below
this paragraph: the same nodes, attrs and JSON, so that either package
loads and prices the other's graphs (``tests/test_torch_capture.py`` holds
the two to that). The cost model, passes and trace tools that the text
below names are the JAX package's; the port has none of them yet.

Node types follow the Chakra ET schema semantics (MLCommons): COMP nodes for
compute kernels, COMM_COLL for collectives, COMM_SEND/COMM_RECV for expanded
point-to-point messages, MEM for host/staging ops.  Two edge kinds:

  * deps      -- *true data dependencies* (SSA operands from the compiler IR;
                 the property that sets Flint apart from CUDA-API capture, SS2.2)
  * ctrl_deps -- scheduling/synchronization edges.  Passes may add/remove
                 these (e.g. FSDP sync injection / AllGather reordering,
                 Fig 3b) but never touch data deps.

Serialized as JSON ET (one file per rank) so external Chakra consumers
(ASTRA-sim, Genie, ...) stay pluggable (P1).

Derived structure (topo order, consumer lists, the costmodel's CompiledGraph)
is memoized on the Graph under a cheap edit token — (n_nodes, n_dep_edges,
n_ctrl_edges, numeric-attr checksum) — so repeated simulate()/pass queries
don't rebuild O(N+E) state.  The token catches every mutation made through
``add()``, every in-place edge edit that changes an edge count, and every
in-place edit of the numeric attrs the cost model reads (flops, bytes,
comm_bytes, out_bytes) or of the attr-key set (hash-exact per value and
position; collisions are astronomically unlikely, not adversarial-proof).
Code that rewrites edge *targets* while keeping counts identical, or that
edits non-numeric attr *values* in place (comm_kind, group contents), must
call ``invalidate_caches()`` — though the codebase idiom is to ``copy()``
before editing (all passes do).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional

COMP = "COMP"
COMM_COLL = "COMM_COLL"
COMM_SEND = "COMM_SEND"
COMM_RECV = "COMM_RECV"
MEM = "MEM"


@dataclasses.dataclass
class Node:
    id: int
    name: str
    type: str
    deps: List[int] = dataclasses.field(default_factory=list)
    ctrl_deps: List[int] = dataclasses.field(default_factory=list)
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def all_deps(self) -> List[int]:
        return self.deps + self.ctrl_deps

    def fingerprint(self) -> str:
        """Stable cross-format identity: name plus op class.  The trace
        subsystem (repro.trace.align) re-identifies nodes in an ingested
        timeline by this string; nodes sharing a fingerprint are
        disambiguated by program order, so it must not depend on node id
        or on attrs a measured trace cannot reproduce."""
        return f"{self.name}|{self.type}"


class Graph:
    def __init__(self, meta: Optional[Dict] = None):
        self.nodes: List[Node] = []
        self.meta: Dict = meta or {}
        self._cache: Dict = {}

    # -- derived-structure cache --------------------------------------------
    def _token(self):
        """Cheap edit token guarding memoized derived structure: node/edge
        counts plus a position-sensitive hash of the numeric attrs the cost
        model reads, so in-place edits like ``g.node(i).attrs["flops"] = x``
        — including swaps between nodes and tiny deltas next to huge values
        (no float-sum absorption) — invalidate too."""
        nodes = self.nodes
        attrs_h = hash(tuple([
            hash((a.get("flops", 0.0), a.get("bytes", 0.0),
                  a.get("comm_bytes", 0.0), a.get("out_bytes", 0.0), len(a)))
            for a in [n.attrs for n in nodes]]))
        return (len(nodes), sum([len(n.deps) for n in nodes]),
                sum([len(n.ctrl_deps) for n in nodes]), attrs_h)

    def invalidate_caches(self):
        """Drop memoized topo order / consumers / compiled form.  Needed only
        after in-place edge retargeting that preserves edge counts."""
        self._cache = {}

    def _cached(self, key: str, build):
        tok = self._token()
        hit = self._cache.get(key)
        if hit is not None and hit[0] == tok:
            return hit[1]
        val = build()
        self._cache[key] = (tok, val)
        return val

    # -- construction -------------------------------------------------------
    def add(self, name: str, type: str, deps: Iterable[int] = (),
            ctrl_deps: Iterable[int] = (), **attrs) -> int:
        nid = len(self.nodes)
        self.nodes.append(Node(nid, name, type, list(deps), list(ctrl_deps),
                               attrs))
        return nid

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    def __len__(self):
        return len(self.nodes)

    # -- queries ------------------------------------------------------------
    def by_type(self, t: str) -> List[Node]:
        return [n for n in self.nodes if n.type == t]

    def consumers(self) -> Dict[int, List[int]]:
        """dep id -> consumer ids (duplicates kept when a consumer lists the
        same dep in both edge kinds).  Memoized; treat the result as
        read-only."""
        return self._cached("consumers", self._build_consumers)

    def _build_consumers(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for d in n.deps:
                out[d].append(n.id)
            for d in n.ctrl_deps:
                out[d].append(n.id)
        return out

    def topo_order(self) -> List[int]:
        """Kahn order with LIFO tie-breaking.  Memoized; treat the result as
        read-only."""
        return self._cached("topo", self._build_topo_order)

    def _build_topo_order(self) -> List[int]:
        n_nodes = len(self.nodes)
        dense = all(n.id == i for i, n in enumerate(self.nodes))
        if dense:
            indeg = [0] * n_nodes
            cons: List[List[int]] = [[] for _ in range(n_nodes)]  # dedup'd
        else:                       # hand-built graphs with arbitrary ids
            indeg = {n.id: 0 for n in self.nodes}
            cons = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            ad = n.deps + n.ctrl_deps
            if len(ad) > 1:
                ad = set(ad)
            indeg[n.id] = len(ad)
            for d in ad:
                cons[d].append(n.id)
        ready = [n.id for n in self.nodes if indeg[n.id] == 0]
        order: List[int] = []
        while ready:
            nid = ready.pop()
            order.append(nid)
            for c in cons[nid]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != n_nodes:
            raise ValueError("graph has a cycle")
        return order

    def validate(self) -> bool:
        ids = {n.id for n in self.nodes}
        for n in self.nodes:
            for d in n.all_deps:
                if d not in ids or d == n.id:
                    raise ValueError(f"bad dep {d} of node {n.id}")
        self.topo_order()
        return True

    # -- stats ---------------------------------------------------------------
    def totals(self) -> Dict:
        flops = sum(n.attrs.get("flops", 0.0) for n in self.nodes)
        bytes_ = sum(n.attrs.get("bytes", 0.0) for n in self.nodes
                     if n.type == COMP)
        comm = {}
        for n in self.by_type(COMM_COLL):
            k = n.attrs.get("comm_kind", "?")
            comm.setdefault(k, [0, 0.0])
            comm[k][0] += 1
            comm[k][1] += n.attrs.get("comm_bytes", 0.0)
        return {"flops": flops, "comp_bytes": bytes_,
                "comm": {k: {"count": c, "bytes": b}
                         for k, (c, b) in comm.items()},
                "comm_bytes": sum(b for _, b in comm.values()),
                "n_nodes": len(self.nodes)}

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "schema": "flint-chakra-et-v1",
            "meta": self.meta,
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
        })

    @classmethod
    def from_json(cls, s: str) -> "Graph":
        d = json.loads(s)
        g = cls(d.get("meta", {}))
        for nd in d["nodes"]:
            g.nodes.append(Node(**nd))
        return g

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Graph":
        with open(path) as f:
            return cls.from_json(f.read())

    def copy(self) -> "Graph":
        g = Graph(dict(self.meta))
        for n in self.nodes:
            g.nodes.append(Node(n.id, n.name, n.type, list(n.deps),
                                list(n.ctrl_deps), dict(n.attrs)))
        return g
