"""Graph dataset over the store (the port of ``ddstore_tpu/data/graphs.py``):
ragged shards → packed static batches.

Per-rank lists of variable-size graphs are registered as ragged
variables (nodes / edge_index / edge_attr) plus a fixed-width target
variable, any rank fetches any graph one-sidedly, and batches are packed
into fixed node/edge budgets (:class:`GraphBatch`) so every step of
:mod:`ddstore_tpu_torch.models.gnn` sees the same shapes. The arrays stay
numpy; :class:`ddstore_tpu_torch.data.loader.DeviceLoader` turns them
into tensors on the card, keeping the named tuple.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np

from .ragged import split_ragged


class GraphBatch(NamedTuple):
    """One packed graph block per device slot (leading axis = device).

    Shapes (D = device slots, NB/EB = node/edge budgets, G = graphs per
    slot, F*/T = feature/target dims). A plain NamedTuple, so it stages
    through :class:`DeviceLoader` field by field and keeps its type.
    """
    nodes: Any        # (D, NB, Fn) float — node features, padded rows zero
    edge_src: Any     # (D, EB) int32 — source node index within the slot
    edge_dst: Any     # (D, EB) int32 — destination node index
    edge_attr: Any    # (D, EB, Fe) float
    edge_mask: Any    # (D, EB) bool — False on padding edges
    node_seg: Any     # (D, NB) int32 — graph id in [0, G]; G == padding
    node_mask: Any    # (D, NB) bool — False on padding nodes
    y: Any            # (D, G, T) float — per-graph targets
    graph_mask: Any   # (D, G) bool — False on padding graph slots


class GraphSample(NamedTuple):
    nodes: np.ndarray       # (n, Fn) float32
    edge_index: np.ndarray  # (e, 2) int64 — [src, dst] within the graph
    edge_attr: np.ndarray   # (e, Fe) float32
    y: np.ndarray           # (T,) float32


def synthetic_graphs(rng: np.random.Generator, n: int, fn: int = 8,
                     fe: int = 4, t: int = 1, min_nodes: int = 4,
                     max_nodes: int = 12, stamp: Optional[float] = None
                     ) -> List[GraphSample]:
    """QM9-shaped synthetic molecular graphs with a learnable smooth
    target (graph mean of a fixed nonlinear projection of node features).
    ``stamp`` overrides node features with a constant — the rank-stamp
    oracle of the store's rank-stamp tests."""
    proj = np.linspace(-1.0, 1.0, fn, dtype=np.float32)
    out = []
    for _ in range(n):
        nn_ = int(rng.integers(min_nodes, max_nodes + 1))
        nodes = rng.standard_normal((nn_, fn)).astype(np.float32)
        if stamp is not None:
            nodes = np.full((nn_, fn), stamp, np.float32)
        # ring + random chords: connected, ~3 edges/node, both directions
        src = np.arange(nn_, dtype=np.int64)
        ring = np.stack([src, (src + 1) % nn_], axis=1)
        chords = rng.integers(0, nn_, size=(nn_, 2)).astype(np.int64)
        ei = np.concatenate([ring, ring[:, ::-1], chords], axis=0)
        ea = rng.standard_normal((len(ei), fe)).astype(np.float32)
        y = np.tanh(nodes @ proj).mean(keepdims=True).astype(np.float32)
        y = np.repeat(y, t)
        out.append(GraphSample(nodes, ei, ea, y))
    return out


def pack_graph_batch(graphs: Sequence[GraphSample], n_slots: int,
                     graphs_per_slot: int, node_budget: int,
                     edge_budget: int) -> GraphBatch:
    """Pack graphs into ``n_slots`` device slots of fixed budgets.

    Graphs that would overflow a slot's remaining node/edge budget are
    skipped (their slot stays masked) — the explicit overflow policy;
    callers size budgets as ``graphs_per_slot * max_nodes`` to make skips
    impossible for bounded datasets.
    """
    g = graphs_per_slot
    fn = graphs[0].nodes.shape[1]
    fe = graphs[0].edge_attr.shape[1]
    t = graphs[0].y.shape[0]
    D = n_slots
    nodes = np.zeros((D, node_budget, fn), np.float32)
    esrc = np.zeros((D, edge_budget), np.int32)
    edst = np.zeros((D, edge_budget), np.int32)
    eattr = np.zeros((D, edge_budget, fe), np.float32)
    emask = np.zeros((D, edge_budget), np.bool_)
    nseg = np.full((D, node_budget), g, np.int32)
    nmask = np.zeros((D, node_budget), np.bool_)
    y = np.zeros((D, g, t), np.float32)
    gmask = np.zeros((D, g), np.bool_)

    for d in range(D):
        npos = epos = 0
        for k in range(g):
            gi = d * g + k
            if gi >= len(graphs):
                break
            s = graphs[gi]
            nn_, ne = len(s.nodes), len(s.edge_index)
            if npos + nn_ > node_budget or epos + ne > edge_budget:
                continue  # slot stays masked for this graph
            nodes[d, npos:npos + nn_] = s.nodes
            nseg[d, npos:npos + nn_] = k
            nmask[d, npos:npos + nn_] = True
            esrc[d, epos:epos + ne] = s.edge_index[:, 0] + npos
            edst[d, epos:epos + ne] = s.edge_index[:, 1] + npos
            eattr[d, epos:epos + ne] = s.edge_attr
            emask[d, epos:epos + ne] = True
            y[d, k] = s.y
            gmask[d, k] = True
            npos += nn_
            epos += ne
    return GraphBatch(nodes, esrc, edst, eattr, emask, nseg, nmask, y, gmask)


class GraphShardedDataset:
    """Store-backed distributed graph dataset.

    Each rank registers its local list of graphs; the global sample space
    is the concatenation across the store group. ``fetch`` returns a packed
    :class:`GraphBatch` ready for the DP train step, so it plugs straight
    into :class:`ddstore_tpu_torch.data.loader.DeviceLoader` (batch_size must be
    ``n_slots * graphs_per_slot``).
    """

    def __init__(self, store, graphs: Sequence[GraphSample],
                 name: str = "graphs", graphs_per_slot: int = 8,
                 node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None):
        self.store = store
        self.name = name
        self.graphs_per_slot = int(graphs_per_slot)
        store.add_ragged(f"{name}/nodes", [g.nodes for g in graphs])
        store.add_ragged(f"{name}/edge_index",
                         [g.edge_index.astype(np.int64) for g in graphs])
        store.add_ragged(f"{name}/edge_attr",
                         [g.edge_attr for g in graphs])
        ys = (np.stack([g.y for g in graphs])
              if graphs else np.empty((0, 1), np.float32))
        store.add(f"{name}/y", ys.astype(np.float32))
        # Budgets must be global (identical shapes on every rank): agree
        # on the max via the group, like the store's row-width agreement
        # but taking the max.
        ln, le = (max((len(g.nodes) for g in graphs), default=0),
                  max((len(g.edge_index) for g in graphs), default=0))
        maxes = store.group.allgather((ln, le))
        max_nodes = max(m[0] for m in maxes)
        max_edges = max(m[1] for m in maxes)
        self.node_budget = int(node_budget or graphs_per_slot * max_nodes)
        self.edge_budget = int(edge_budget or graphs_per_slot * max_edges)

    def __len__(self) -> int:
        return self.store.ragged_total(f"{self.name}/nodes")

    def fetch_graphs(self, indices) -> List[GraphSample]:
        """Raw per-graph fetch (three batched ragged reads + one fixed)."""
        idx = np.ascontiguousarray(indices, np.int64).reshape(-1)
        nv, nl = self.store.get_ragged_batch(f"{self.name}/nodes", idx)
        ev, el = self.store.get_ragged_batch(f"{self.name}/edge_index", idx)
        av, al = self.store.get_ragged_batch(f"{self.name}/edge_attr", idx)
        ys = self.store.get_batch(f"{self.name}/y", idx)
        nodes = split_ragged(nv, nl)
        eidx = split_ragged(ev, el)
        eattr = split_ragged(av, al)
        return [GraphSample(n, e, a, y)
                for n, e, a, y in zip(nodes, eidx, eattr, ys)]

    def fetch(self, indices) -> GraphBatch:
        graphs = self.fetch_graphs(indices)
        if len(graphs) == 0 or len(graphs) % self.graphs_per_slot:
            # Silently dropping the tail would exclude samples from
            # training and vary the leading dim (new shapes on every
            # rank); batch sizes must be a multiple of graphs_per_slot
            # (use DeviceLoader's drop_last for ragged tails).
            raise ValueError(
                f"fetch: got {len(graphs)} graphs, need a nonzero multiple "
                f"of graphs_per_slot={self.graphs_per_slot}")
        n_slots = len(graphs) // self.graphs_per_slot
        return pack_graph_batch(graphs, n_slots, self.graphs_per_slot,
                                self.node_budget, self.edge_budget)

    def free(self) -> None:
        for suffix in ("nodes/values", "nodes/index", "edge_index/values",
                       "edge_index/index", "edge_attr/values",
                       "edge_attr/index", "y"):
            self.store.free(f"{self.name}/{suffix}")
