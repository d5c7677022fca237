"""The world and the query stream of a cell, made from the seed.

A copy of the port's synthetic world (``data/synthetic.py``: the
``SyntheticWorld`` generative model, the ``DATASETS`` presets and numpy
2.0's Zipf loop), rewritten so that the corpus and the query embeddings are
drawn on the device with a ``torch.Generator`` in a few large calls.  The
draws are this benchmark's own: the same seed gives the same rows and
stream here, not the port's or the JAX package's world.

World (a configuration's ``world`` and ``d``): ``n_entities`` entities of
``docs_per_entity`` documents; a document's embedding is
``unit(w_e * entity + w_ad * mix + n_d * unit(noise))``, ``mix`` the sum of
``attrs_per_doc`` distinct attribute vectors of the entity's
``attrs_per_entity`` over ``sqrt(attrs_per_doc)``.  Row ``e * docs + i`` is
document ``i`` of entity ``e``.

Stream (a traffic mix): query entities by Zipf rank (``zipf_a``) over a
seeded permutation of the entities, or uniform (``pattern: "scattered"``);
the attribute is one no document covers with probability
``p_uncovered * r / (r + 30) * 1.35`` (``r`` the entity's rank), else a
covered one; the embedding is ``unit(w_e * entity + w_aq * attr +
n_q * unit(noise))``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

_INT64_MAX = float(np.iinfo(np.int64).max)
ENTITY_CHUNK = 65536        # entities whose documents are drawn per call


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def zipf(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0.2 draws it, on any numpy.

    Each attempt takes two uniforms ``U = 1 - next_double``,
    ``V = next_double``, proposes ``X = floor(U ** (-1 / (a - 1)))`` and
    accepts when ``V X (T - 1) / (b - 1) <= T / b`` (``T = (1 + 1/X) **
    (a - 1)``, ``b = 2 ** (a - 1)``).  Uniforms come in blocks from
    ``rng.random``; the state is then rewound and advanced by exactly the
    attempts used, so the Generator ends where numpy 2.0 leaves it.
    """
    if a <= 1.0:
        raise ValueError("a must be > 1")
    n = int(size)
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    inv = -1.0 / am1
    out = np.empty(n, np.int64)
    got = 0
    while got < n:
        state = rng.bit_generator.state
        block = rng.random(2 * (n - got) + 64).tolist()
        used = 0
        for j in range(0, len(block), 2):
            used += 2
            v = block[j + 1]
            try:
                x = float(math.floor(math.pow(1.0 - block[j], inv)))
            except OverflowError:        # X = inf: above INT64_MAX, rejected
                continue
            if x > _INT64_MAX or x < 1.0:
                continue
            t = math.pow(1.0 + 1.0 / x, am1)
            if v * x * (t - 1.0) / (b - 1.0) <= t / b:
                out[got] = int(x)
                got += 1
                if got == n:
                    break
        rng.bit_generator.state = state
        rng.random(used)
    return out


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


@dataclasses.dataclass
class World:
    corpus: torch.Tensor         # [N, d] f32, unit rows, on the device
    entity_vecs: torch.Tensor    # [E, d] f32
    attr_basis: torch.Tensor     # [A, d] f32
    entity_attrs: np.ndarray     # [E, A] bool: attributes some doc covers


def make_world(cfg: dict, seed: int, device) -> World:
    """The corpus of configuration ``cfg`` drawn from ``seed`` on
    ``device``."""
    w, d = cfg["world"], int(cfg["d"])
    n_e, per = int(w["n_entities"]), int(w["docs_per_entity"])
    n_a, apd = int(w["attrs_per_entity"]), int(w["attrs_per_doc"])
    enc = w["encoder"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(subseed(seed, "world"))
    entity = _unit(torch.randn(n_e, d, generator=g, device=dev))
    attr = _unit(torch.randn(n_a, d, generator=g, device=dev))
    corpus = torch.empty((n_e, per, d), dtype=torch.float32, device=dev)
    covered = torch.zeros((n_e, n_a), dtype=torch.bool, device=dev)
    for e0 in range(0, n_e, ENTITY_CHUNK):
        e1 = min(n_e, e0 + ENTITY_CHUNK)
        ent = entity[e0:e1]
        for i in range(per):
            keys = torch.rand(e1 - e0, n_a, generator=g, device=dev)
            sel = keys.argsort(dim=1)[:, :apd]                    # [e, apd]
            covered[e0:e1].scatter_(1, sel, True)
            mix = attr[sel].sum(dim=1) / math.sqrt(apd)
            noise = _unit(torch.randn(e1 - e0, d, generator=g, device=dev))
            corpus[e0:e1, i] = _unit(enc["entity_weight"] * ent
                                     + enc["attr_weight_doc"] * mix
                                     + enc["noise_doc"] * noise)
    return World(corpus=corpus.reshape(n_e * per, d), entity_vecs=entity,
                 attr_basis=attr, entity_attrs=covered.cpu().numpy())


@dataclasses.dataclass
class Stream:
    emb: np.ndarray          # [n, d] f32 query embeddings (host)
    entity: np.ndarray       # [n] int64
    attr: np.ndarray         # [n] int64


def stream_length(mix: dict, seconds: float, extra_steps: int) -> int:
    """Queries drawn for a run: the fill's most, ``max_qps`` over the window
    and ``extra_steps`` more micro-batches, in whole micro-batches."""
    batch = int(mix["batch"])
    n = (int(mix["fill_queries"]) + int(math.ceil(mix["max_qps"] * seconds))
         + int(extra_steps) * batch)
    return -(-n // batch) * batch


def entity_draws(mix: dict, n_entities: int, n: int,
                 rng: np.random.Generator):
    """-> (entities [n], rank of each entity [E] or None)."""
    if mix["pattern"] == "scattered":
        return rng.integers(0, n_entities, n), None
    a = float(mix["zipf_a"])
    ranks = zipf(rng, a, 4 * n)
    ranks = ranks[ranks <= n_entities][:n] - 1
    while len(ranks) < n:
        extra = zipf(rng, a, n) - 1
        ranks = np.concatenate([ranks, extra[extra < n_entities]])[:n]
    perm = rng.permutation(n_entities)
    rank_of = np.empty(n_entities, np.int64)
    rank_of[perm] = np.arange(n_entities)
    return perm[ranks], rank_of


def make_stream(world: World, cfg: dict, mix: dict, seed: int,
                n: int) -> Stream:
    """``n`` queries of traffic mix ``mix`` over ``world``."""
    enc = cfg["world"]["encoder"]
    n_e, n_a = world.entity_attrs.shape
    rng = np.random.default_rng(subseed(seed, "stream"))
    entities, rank_of = entity_draws(mix, n_e, n, rng)
    covered = world.entity_attrs[entities]                      # [n, A]
    p_unc = np.full(n, float(mix["p_uncovered"]))
    if rank_of is not None:
        r = rank_of[entities].astype(np.float64)
        p_unc = p_unc * (r / (r + 30.0)) * 1.35
    ask_unc = (~covered).any(axis=1) & (rng.random(n) < p_unc)
    pool = np.where(ask_unc[:, None], ~covered, covered)
    keys = np.where(pool, rng.random((n, n_a)), -1.0)
    attrs = keys.argmax(axis=1)
    dev = world.corpus.device
    g = torch.Generator(device=dev).manual_seed(subseed(seed, "queries"))
    noise = _unit(torch.randn(n, world.corpus.shape[1], generator=g,
                              device=dev))
    ent_t = torch.as_tensor(entities, device=dev)
    att_t = torch.as_tensor(attrs, device=dev)
    q = _unit(enc["entity_weight"] * world.entity_vecs[ent_t]
              + enc["attr_weight_query"] * world.attr_basis[att_t]
              + enc["noise_query"] * noise)
    return Stream(emb=q.cpu().numpy(), entity=entities.astype(np.int64),
                  attr=attrs.astype(np.int64))
