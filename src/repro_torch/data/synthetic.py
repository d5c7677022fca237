"""Synthetic entity–attribute RAG world (dataset substrate for all paper tables).

The paper evaluates on Wikipedia + (augmented) Granola-EQ / PopQA.  Neither
the 49.2M-passage dump nor an 8B LLM ships with this repository, so we build a
*measurable* synthetic world that preserves every property the paper's
mechanisms depend on:

  1. Entity-centric encoder bias (§III-A obs. 1): document embeddings are
     dominated by their entity vector, so retrieval is entity-aligned.
  2. Multi-attribute coverage (obs. 2): each document covers several
     attributes of its entity, so homologous queries share golden docs.
  3. Popularity patterns (Fig. 4): query entities are Zipf-distributed
     ('granola'/'popqa' presets) or scattered ('triviaqa'/'squad' presets).
  4. Golden-document ground truth: G(d, q) = [E(d) = E(q)] ∧ [A(q) ∈ A(d)]
     is known exactly, giving oracle Doc-Hit / CAR metrics.
  5. Response accuracy: a calibrated generator answers correctly with
     p_hit when a golden doc is retrieved and p_miss otherwise (the paper's
     RA is the same monotone function of Doc-Hit, measured through an LLM).

Different 'encoders' (Table VIII) = different (entity-weight, attr-weight,
noise) triples, reproducing the encoder-robustness axis.

Every draw is a numpy ``Generator`` draw, so the port builds the
reference's world and streams byte for byte, with one exception that numpy
itself introduced: ``Generator.zipf`` changed its rejection loop after
numpy 2.0 (numpy 2.3 samples ``U`` from ``(Umin, 1]`` where 2.0 took
``1 - next_double``), and the same seed gives other ranks from the second
draw on.  :func:`zipf` is numpy 2.0's loop over the Generator's own
uniforms, so the streams do not depend on the installed numpy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.retrieval.lexical import build_doc_terms, query_terms


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    n_entities: int = 20000
    docs_per_entity: int = 5
    attrs_per_entity: int = 12     # distinct attributes an entity can have
    attrs_per_doc: int = 4         # multi-attribute coverage per document
    d: int = 64
    # encoder profile (noise scales are vector norms: noise is unit-direction
    # * scale, NOT per-component — see calibration in tests/test_world.py)
    entity_weight: float = 1.0     # entity-centric bias strength
    attr_weight_doc: float = 0.55
    attr_weight_query: float = 0.65
    noise_doc: float = 1.0         # calibrated: 2.39/5 entity-aligned top-5,
    noise_query: float = 1.1       # 73% top-1 aligned (paper: 2.35, 64.3%)
    seed: int = 0

    @property
    def n_docs(self) -> int:
        return self.n_entities * self.docs_per_entity


# encoder presets (Table VIII): robustness across encoder families
_INT64_MAX = float(np.iinfo(np.int64).max)


def zipf(rng: np.random.Generator, a: float, size: int | None = None):
    """``rng.zipf(a, size)`` as numpy 2.0.2 draws it, on any numpy.

    The rejection loop of numpy 2.0's ``random_zipf``: each attempt takes
    two uniforms ``U = 1 - next_double``, ``V = next_double``, proposes
    ``X = floor(U ** (-1 / (a - 1)))`` and accepts when
    ``V X (T - 1) / (b - 1) <= T / b`` (``T = (1 + 1/X) ** (a - 1)``,
    ``b = 2 ** (a - 1)``).  Uniforms come in blocks from ``rng.random``;
    the state is then rewound and advanced by exactly the attempts used,
    so the Generator ends where numpy 2.0 would leave it.  ``math.pow`` is
    the C library's ``pow``, as in numpy's C loop.
    """
    if a <= 1.0:
        raise ValueError("a must be > 1")
    n = 1 if size is None else int(size)
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
    return int(out[0]) if size is None else out


ENCODERS = {
    "contriever": dict(entity_weight=1.0, attr_weight_doc=0.55,
                       attr_weight_query=0.65, noise_doc=1.0, noise_query=1.1),
    "bge-large": dict(entity_weight=1.1, attr_weight_doc=0.60,
                      attr_weight_query=0.70, noise_doc=0.95, noise_query=1.05),
    "e5-base": dict(entity_weight=0.95, attr_weight_doc=0.50,
                    attr_weight_query=0.62, noise_doc=1.05, noise_query=1.15),
}


class SyntheticWorld:
    """Corpus + oracle + query sampler."""

    def __init__(self, cfg: WorldConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        d = cfg.d

        def unit(x):
            return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)

        self.entity_vecs = unit(rng.normal(size=(cfg.n_entities, d))).astype(np.float32)
        self.attr_basis = unit(rng.normal(size=(cfg.attrs_per_entity, d))).astype(np.float32)

        # documents: doc -> (entity, attr bitmask)
        n_docs = cfg.n_docs
        self.doc_entity = np.repeat(np.arange(cfg.n_entities), cfg.docs_per_entity)
        self.doc_attr_mask = np.zeros((n_docs, cfg.attrs_per_entity), bool)
        attr_mix = np.zeros((n_docs, d), np.float32)
        for i in range(cfg.docs_per_entity):
            sel = rng.random((cfg.n_entities, cfg.attrs_per_entity)).argsort(axis=1)
            sel = sel[:, :cfg.attrs_per_doc]                       # [E, apd]
            rows = np.arange(cfg.n_entities * cfg.docs_per_entity)[
                i::cfg.docs_per_entity]
            for j in range(cfg.attrs_per_doc):
                self.doc_attr_mask[rows, sel[:, j]] = True
            attr_mix[rows] = self.attr_basis[sel].sum(axis=1) \
                / np.sqrt(cfg.attrs_per_doc)

        emb = (cfg.entity_weight * self.entity_vecs[self.doc_entity]
               + cfg.attr_weight_doc * attr_mix
               + cfg.noise_doc * unit(rng.normal(size=(n_docs, d))))
        self.doc_emb = unit(emb).astype(np.float32)

        # entity -> attribute availability (a query can only ask attrs that
        # at least one doc of the entity covers)
        self.entity_attrs = np.zeros((cfg.n_entities, cfg.attrs_per_entity), bool)
        np.logical_or.at(self.entity_attrs, self.doc_entity, self.doc_attr_mask)

        # hashed-term postings for the lexical channel — pure hashing of the
        # arrays above, zero rng draws, so every embedding/query stream stays
        # bit-identical to worlds built before the hybrid backend existed
        self.doc_terms, self.doc_term_weights = build_doc_terms(
            self.doc_entity, self.doc_attr_mask)

    # -- query construction ------------------------------------------------

    def encode_query(self, entity: int, attr: int,
                     rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        noise = rng.normal(size=cfg.d)
        noise /= max(np.linalg.norm(noise), 1e-8)
        v = (cfg.entity_weight * self.entity_vecs[entity]
             + cfg.attr_weight_query * self.attr_basis[attr]
             + cfg.noise_query * noise)
        return (v / max(np.linalg.norm(v), 1e-8)).astype(np.float32)

    def golden_mask(self, entity: int, attr: int,
                    doc_ids: np.ndarray) -> np.ndarray:
        """G(d, q) for each retrieved doc id (vectorized oracle)."""
        ids = np.asarray(doc_ids)
        ok = ids >= 0
        safe = np.where(ok, ids, 0)
        g = (self.doc_entity[safe] == entity) & self.doc_attr_mask[safe, attr]
        return g & ok

    # -- query streams -----------------------------------------------------

    def sample_queries(self, n: int, pattern: str = "zipf",
                       zipf_a: float = 1.15, seed: int = 1,
                       n_templates: int = 5, p_uncovered: float = 0.0):
        """Returns list of dicts: {entity, attr, emb, tokens}.

        pattern='zipf' reproduces the popularity concentration (Fig. 4);
        'scattered' reproduces de-duplicated QA datasets (Table V).
        ``p_uncovered`` = fraction of queries asking an attribute no corpus
        document covers (the real-world knowledge gap that bounds Doc-Hit).
        """
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        if pattern == "zipf":
            ranks = zipf(rng, zipf_a, size=4 * n)
            ranks = ranks[ranks <= cfg.n_entities][:n] - 1
            while len(ranks) < n:
                extra = zipf(rng, zipf_a, size=n) - 1
                ranks = np.concatenate([ranks, extra[extra < cfg.n_entities]])[:n]
            perm = rng.permutation(cfg.n_entities)
            entities = perm[ranks]
            rank_of = np.empty(cfg.n_entities, np.int64)
            rank_of[perm] = np.arange(cfg.n_entities)
        else:
            entities = rng.integers(0, cfg.n_entities, n)
            rank_of = None

        out = []
        for e in entities:
            covered = np.flatnonzero(self.entity_attrs[e])
            uncovered = np.flatnonzero(~self.entity_attrs[e])
            # popular entities are better covered in real corpora: scale the
            # knowledge-gap probability down for head entities (drives the
            # paper's high CAR on accepted, i.e. re-encountered, queries)
            p_unc = p_uncovered
            if rank_of is not None:
                r = float(rank_of[e])
                p_unc = p_uncovered * (r / (r + 30.0)) * 1.35
            if len(uncovered) and rng.random() < p_unc:
                a = int(rng.choice(uncovered))
            else:
                a = int(rng.choice(covered)) if len(covered) else 0
            emb = self.encode_query(int(e), a, rng)
            tmpl = int(rng.integers(n_templates))
            # token ids: template tokens + entity token + attr token
            tokens = np.array([1000 + tmpl * 7 + t for t in range(4)]
                              + [10_000 + int(e), 100_000 + a], np.int64)
            terms, term_weights = query_terms(int(e), a)
            out.append({"entity": int(e), "attr": a, "emb": emb,
                        "tokens": tokens, "terms": terms,
                        "term_weights": term_weights})
        return out


DATASETS = {
    # query pattern + LLM answer calibration (p_hit/p_miss reproduce the
    # paper's RA levels given its Doc-Hit levels: e.g. granola Qwen3 RA
    # 0.4875 at hit 0.6457 -> p_hit*0.6457 + p_miss*0.3543 = 0.4875)
    "granola": dict(pattern="zipf", zipf_a=1.12, p_uncovered=0.42,
                    p_hit={"qwen3-8b": 0.745, "llama3-8b": 0.720,
                           "mixtral-7b": 0.735},
                    p_miss={"qwen3-8b": 0.022, "llama3-8b": 0.020,
                            "mixtral-7b": 0.021}),
    "popqa": dict(pattern="zipf", zipf_a=1.30, p_uncovered=0.68,
                  p_hit={"qwen3-8b": 0.615, "llama3-8b": 0.575,
                         "mixtral-7b": 0.560},
                  p_miss={"qwen3-8b": 0.018, "llama3-8b": 0.016,
                          "mixtral-7b": 0.015}),
    # TriviaQA/SQuAD deviate from popularity patterns but are not fully
    # entity-deduplicated: a light Zipf tail remains (Table V's premise)
    "triviaqa": dict(pattern="zipf", zipf_a=1.04, p_uncovered=0.05,
                     p_hit={"qwen3-8b": 0.80}, p_miss={"qwen3-8b": 0.30}),
    "squad": dict(pattern="zipf", zipf_a=1.01, p_uncovered=0.30,
                  p_hit={"qwen3-8b": 0.42}, p_miss={"qwen3-8b": 0.02}),
}


def simulate_response_accuracy(rng: np.random.Generator, doc_hit: bool,
                               dataset: str = "granola",
                               llm: str = "qwen3-8b",
                               n_docs: int = 10) -> bool:
    """p_hit degrades mildly beyond ~10 context docs (the lost-in-the-middle
    effect of long RAG prompts [Jin et al., ICLR'25] — Fig 11's U-shape)."""
    cal = DATASETS[dataset]
    p = cal["p_hit"].get(llm, 0.7) if doc_hit else cal["p_miss"].get(llm, 0.02)
    if doc_hit and n_docs > 10:
        p *= max(0.5, 1.0 - 0.008 * (n_docs - 10))
    return bool(rng.random() < p)
