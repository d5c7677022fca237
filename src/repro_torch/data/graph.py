"""Graph data: synthetic graphs, triplet builder, fanout neighbor sampler.

Twin of ``src/repro/data/graph.py``: numpy, with the reference's draws in
its order (``build_triplets`` calls ``rng.choice`` once per over-full edge,
the sampler once per over-full node), so both packages build the same
arrays from the same seed.  Every graph batch is a fixed-size padded block:
edges [E_max], triplets [T_max] with masks; ``build_triplets`` caps the
directional triplets (k->j->i) per edge, which bounds DimeNet's triplet
tensor on power-law graphs.
"""
from __future__ import annotations

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 seed: int = 0, radius_graph: bool = False):
    """Synthetic node-classification graph with 3-D positions."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    if radius_graph and n_nodes <= 5000:
        # connect k-nearest for geometric realism (molecule regime)
        d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = max(1, n_edges // n_nodes)
        nbr = np.argsort(d2, axis=1)[:, :k]
        src = nbr.reshape(-1)
        dst = np.repeat(np.arange(n_nodes), k)
    else:
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    src, dst = src[:n_edges], dst[:n_edges]
    # class-correlated features so training can learn
    labels = rng.integers(0, n_classes, n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    x = centers[labels] + 0.5 * rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return {"x": x.astype(np.float32), "pos": pos,
            "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
            "labels": labels.astype(np.int32)}


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray,
                   cap_per_edge: int, t_max: int, seed: int = 0):
    """Directional triplets: for edge e=(j->i), up to ``cap`` edges (k->j).

    Returns (tri_edge_in [T_max], tri_edge_out [T_max], tri_mask [T_max]).
    """
    rng = np.random.default_rng(seed)
    e = len(edge_src)
    # incoming edge lists per node
    order = np.argsort(edge_dst, kind="stable")
    sorted_dst = edge_dst[order]
    starts = np.searchsorted(sorted_dst, np.arange(edge_dst.max() + 2))
    t_in, t_out = [], []
    for eid in range(e):
        j = edge_src[eid]
        if j + 1 >= len(starts):
            continue
        lo, hi = starts[j], starts[j + 1]
        incoming = order[lo:hi]
        incoming = incoming[edge_src[incoming] != edge_dst[eid]]  # k != i
        if len(incoming) > cap_per_edge:
            incoming = rng.choice(incoming, cap_per_edge, replace=False)
        for kid in incoming:
            t_in.append(kid)
            t_out.append(eid)
            if len(t_in) >= t_max:
                break
        if len(t_in) >= t_max:
            break
    t = len(t_in)
    tri_in = np.zeros(t_max, np.int32)
    tri_out = np.zeros(t_max, np.int32)
    mask = np.zeros(t_max, bool)
    tri_in[:t] = t_in
    tri_out[:t] = t_out
    mask[:t] = True
    return tri_in, tri_out, mask


def make_graph_batch(n_nodes, n_edges, d_feat, n_classes, t_max=None,
                     cap_per_edge=4, seed=0, radius_graph=False):
    g = random_graph(n_nodes, n_edges, d_feat, n_classes, seed, radius_graph)
    t_max = t_max or cap_per_edge * n_edges
    ti, to, tm = build_triplets(g["edge_src"], g["edge_dst"], cap_per_edge,
                                t_max, seed)
    return {**g, "edge_mask": np.ones(n_edges, bool),
            "tri_edge_in": ti, "tri_edge_out": to, "tri_mask": tm,
            "node_mask": np.ones(n_nodes, bool)}


class NeighborSampler:
    """Uniform fanout sampling (GraphSAGE-style) producing fixed-shape blocks.

    The full graph lives on the host in CSR form; each call samples a
    ``batch_nodes``-seed subgraph with the given fanouts and emits padded
    edge/triplet arrays — the ``minibatch_lg`` training regime.
    """

    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 n_nodes: int, seed: int = 0):
        order = np.argsort(edge_dst, kind="stable")
        self.sorted_src = edge_src[order]
        self.starts = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.starts[1:] = np.cumsum(counts)
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int):
        """Returns (src, dst) edges: up to ``fanout`` in-neighbors per node."""
        srcs, dsts = [], []
        for v in nodes:
            lo, hi = self.starts[v], self.starts[v + 1]
            if hi <= lo:
                continue
            nbrs = self.sorted_src[lo:hi]
            if len(nbrs) > fanout:
                nbrs = self.rng.choice(nbrs, fanout, replace=False)
            srcs.append(nbrs)
            dsts.append(np.full(len(nbrs), v, np.int64))
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(srcs), np.concatenate(dsts)

    def sample_block(self, seeds: np.ndarray, fanouts: tuple[int, ...],
                     e_max: int):
        """Multi-hop block: returns node set + padded local edge arrays."""
        frontier = seeds
        all_src, all_dst = [], []
        for f in fanouts:
            s, d = self.sample_neighbors(np.unique(frontier), f)
            all_src.append(s)
            all_dst.append(d)
            frontier = s
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
        nodes = np.unique(np.concatenate([seeds, src, dst]))
        remap = {int(g): i for i, g in enumerate(nodes)}
        lsrc = np.array([remap[int(g)] for g in src], np.int32)
        ldst = np.array([remap[int(g)] for g in dst], np.int32)
        n_e = min(len(lsrc), e_max)
        edge_src = np.zeros(e_max, np.int32)
        edge_dst = np.zeros(e_max, np.int32)
        emask = np.zeros(e_max, bool)
        edge_src[:n_e] = lsrc[:n_e]
        edge_dst[:n_e] = ldst[:n_e]
        emask[:n_e] = True
        return nodes, edge_src, edge_dst, emask
