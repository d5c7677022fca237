"""Agentic RAG (paper §IV-E II): Auto-RAG multi-hop queries as hop graphs.

The port of the reference's ``serving/agentic.py``: host code, copied.
Zipf ranks come from ``data/synthetic.py::zipf`` (numpy 2.0's loop over
the Generator's uniforms, so the complex queries do not depend on the
installed numpy); every other draw and the ``_SUB_*`` substream tags are
the reference's, so the hop graphs are equal.

Complex queries reference a chain of bridge relations: "What is
A(r(e1))?" decomposes into hop-1 "what entity is r(e1)?" (answered by a
relation document of e1) and hop-2 "what is A(e2)?" — and, for ``hops``
> 2, longer chains of the same shape.  Decomposed sub-queries
concentrate on popular entities even harder than raw queries (hub
entities appear as many queries' bridge), which drives the paper's
69.4% retrieval-latency cut at high DAR.

This module is the DECOMPOSITION layer.  Execution lives in two places:

* the sequential executor here (``AutoRagPipeline`` over a per-query
  engine such as :class:`~repro_torch.serving.engine.HasEngine`, or ``None``
  for the always-full baseline) — the paper's plug-in arm, hops strictly
  serial, reasoning charged per hop from
  :attr:`~repro_torch.serving.latency.LatencyModel.reason_scale`;
* the continuous-batching scheduler (``serving/scheduler.py``), where a
  complex query enters admission as its hop-1 sub-query carrying a
  :class:`HopPlan` continuation (``q["hop_plan"]``).  The scheduler
  resolves the hop graph on the virtual clock: reasoning is charged via
  the ``reason`` trace stage, hop-(h+1) is *pre-speculated* from hop-h's
  accepted-or-rejected draft before validation/full retrieval lands, and
  mis-speculated hops are cancelled deterministically (the Speculative
  RAG drafting idea, applied across hops).

Every nondeterministic choice a hop graph makes (query encoding, the
lucky-guess bridge, the wrong-entity guess, answer accuracy) is drawn
from a per-(complex-query, hop) substream of ``np.random.default_rng``
— independent of scheduling order — so the sequential and scheduled
arms, and the drafted and validated bridges within one run, are
comparable at equal DAR/accuracy by construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import (SyntheticWorld,
                                        simulate_response_accuracy, zipf)
from repro_torch.retrieval.lexical import query_terms

#: probability the agent guesses the right bridge entity from an
#: ungrounded hop (the paper's LLM sometimes knows the relation anyway)
LUCKY_BRIDGE_P = 0.15

# substream tags keeping the per-hop rng draws disjoint (HopPlan)
_SUB_BRIDGE, _SUB_QUERY, _SUB_ACC = 101, 103, 107


@dataclasses.dataclass
class TwoHopDataset:
    """Synthetic complex queries over relation permutations.

    Deterministic in ``seed``: the relation maps are built once in
    ``__post_init__`` and ``sample`` draws from its own seeded stream, so
    the same (dataset seed, sample seed) always yields identical
    relations and samples.  Despite the name, ``sample(hops=H)`` builds
    H-hop chains for any H >= 1 (2 stays the default and the paper's
    Fig-13 shape).
    """
    world: SyntheticWorld
    n_relations: int = 4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.world.cfg.n_entities
        # each relation is a mapping entity -> entity, biased toward hubs:
        # half the targets collapse onto a small popular set
        hubs = rng.choice(n, max(8, n // 100), replace=False)
        self.relations = []
        for _ in range(self.n_relations):
            perm = rng.permutation(n)
            collapse = rng.random(n) < 0.5
            perm[collapse] = rng.choice(hubs, collapse.sum())
            self.relations.append(perm)
        # relation attribute ids: reuse the first n_relations attrs
        self.rel_attr = list(range(self.n_relations))

    def sample(self, n: int, zipf_a: float = 1.12, seed: int = 1,
               hops: int = 2):
        """Draw ``n`` complex queries as ``hops``-long entity chains.

        Returns dicts with ``entities`` (chain, length ``hops``),
        ``rels`` (relation per bridge, length ``hops - 1``) and ``attr``
        (final-hop attribute); 2-hop samples also carry the legacy
        ``e1``/``rel``/``e2``/``attr2`` keys.  The 2-hop draw sequence is
        unchanged from the pre-hop-graph version of this module.
        """
        if hops < 1:
            raise ValueError(f"hops must be >= 1, got {hops}")
        rng = np.random.default_rng(seed)
        w = self.world
        out = []
        for _ in range(n):
            ranks = zipf(rng, zipf_a)
            e = int(min(ranks - 1, w.cfg.n_entities - 1))
            entities, rels = [e], []
            for _h in range(hops - 1):
                r = int(rng.integers(self.n_relations))
                rels.append(r)
                e = int(self.relations[r][e])
                entities.append(e)
            attrs = np.flatnonzero(w.entity_attrs[entities[-1]])
            a = int(rng.choice(attrs)) if len(attrs) else 0
            cq = {"entities": entities, "rels": rels, "attr": a}
            if hops == 2:
                cq.update(e1=entities[0], rel=rels[0], e2=entities[1],
                          attr2=a)
            out.append(cq)
        return out


class HopPlan:
    """One complex query's decomposed hop graph (the continuation).

    Owns every rng decision of the chain as per-(uid, hop) substreams so
    results are independent of WHEN a hop executes:

    * ``bridge(h, hit)`` — the entity the agent reasons out for hop h+1
      from hop h's retrieval: the true next entity iff the hop was
      grounded (``hit``) or the fixed per-hop lucky draw fires, else a
      fixed per-hop random guess.  Because the lucky/guess draws are
      frozen per hop (not per call), a bridge derived from hop-h's DRAFT
      and one derived from its final retrieval agree whenever their
      doc-hits agree — which is what makes cross-hop pre-speculation
      confirmable.
    * ``query(h, entity)`` — the encoded sub-query for hop h, keyed by
      entity so a corrected re-enqueue after mis-speculation re-encodes
      identically.
    * ``accuracy(ok, dataset)`` — the final-answer draw.
    """

    def __init__(self, world: SyntheticWorld, rel_attr, entities, rels,
                 attr: int, uid: int, seed: int = 0, tenant: int = 0):
        if len(entities) != len(rels) + 1:
            raise ValueError(
                f"chain of {len(entities)} entities needs "
                f"{len(entities) - 1} relations, got {len(rels)}")
        self.world = world
        self.rel_attr = list(rel_attr)
        self.entities = [int(e) for e in entities]
        self.rels = [int(r) for r in rels]
        self.attr = int(attr)
        self.hops = len(self.entities)
        self.uid = int(uid)
        self.seed = int(seed)
        self.tenant = int(tenant)
        self._bridges: dict[int, tuple[bool, int]] = {}

    def attr_of(self, h: int) -> int:
        """Attribute asked at hop ``h`` (1-based): the bridge relation's
        attribute for inner hops, the final attribute for the last."""
        return (self.rel_attr[self.rels[h - 1]] if h < self.hops
                else self.attr)

    def true_entity(self, h: int) -> int:
        return self.entities[h - 1]

    def hit(self, h: int, ids) -> bool:
        """Did hop ``h``'s retrieval ground the TRUE hop-h fact?  (A
        mis-bridged retrieval ran off-entity and almost surely misses.)"""
        ids = np.asarray(ids)
        if ids.size == 0:
            return False
        return bool(self.world.golden_mask(self.true_entity(h),
                                           self.attr_of(h), ids).any())

    def bridge(self, h: int, hit: bool) -> int:
        """Entity the agent reasons out for hop ``h + 1``."""
        if h not in self._bridges:
            rng = np.random.default_rng(
                [self.seed, self.uid, _SUB_BRIDGE, h])
            self._bridges[h] = (
                bool(rng.random() < LUCKY_BRIDGE_P),
                int(rng.integers(self.world.cfg.n_entities)))
        lucky, guess = self._bridges[h]
        return self.entities[h] if (hit or lucky) else guess

    def query(self, h: int, entity: int) -> dict:
        """Engine/scheduler-ready sub-query dict for hop ``h``."""
        attr = self.attr_of(h)
        rng = np.random.default_rng(
            [self.seed, self.uid, _SUB_QUERY, h, int(entity)])
        emb = self.world.encode_query(int(entity), attr, rng)
        tmpl = int(rng.integers(5))
        tokens = np.array([1000 + tmpl * 7 + t for t in range(4)]
                          + [10_000 + int(entity), 100_000 + attr],
                         np.int64)
        terms, term_weights = query_terms(int(entity), attr)
        return {"entity": int(entity), "attr": attr, "emb": emb,
                "tokens": tokens, "terms": terms,
                "term_weights": term_weights, "tenant": self.tenant}

    def root_query(self) -> dict:
        """The hop-1 sub-query that enters scheduler admission, carrying
        this plan as its continuation."""
        q = self.query(1, self.true_entity(1))
        q["hop_plan"] = self
        return q

    def accuracy(self, all_hits: bool, dataset: str) -> bool:
        rng = np.random.default_rng([self.seed, self.uid, _SUB_ACC])
        return simulate_response_accuracy(rng, all_hits, dataset)


def decompose(ds: TwoHopDataset, complex_queries, seed: int = 0,
              tenants=None) -> list[HopPlan]:
    """Build one :class:`HopPlan` per complex query (legacy 2-hop dicts
    and chain dicts both accepted)."""
    plans = []
    for i, cq in enumerate(complex_queries):
        if "entities" in cq:
            ents, rels, attr = cq["entities"], cq["rels"], cq["attr"]
        else:
            ents, rels, attr = [cq["e1"], cq["e2"]], [cq["rel"]], cq["attr2"]
        plans.append(HopPlan(ds.world, ds.rel_attr, ents, rels, attr,
                             uid=i, seed=seed,
                             tenant=0 if tenants is None else int(tenants[i])))
    return plans


def build_hop_trace(ds: TwoHopDataset, complex_queries, seed: int = 0,
                    tenants=None) -> list[dict]:
    """Scheduler-ready trace: each complex query becomes its hop-1
    sub-query with the plan continuation attached (``q["hop_plan"]``)."""
    return [p.root_query() for p in decompose(ds, complex_queries, seed,
                                              tenants)]


class AutoRagPipeline:
    """Chain-of-thought loop: decompose -> retrieve (per hop) -> answer.

    ``engine`` selects the execution substrate:

    * :class:`~repro_torch.serving.engine.HasEngine` (or any per-query
      ``step()`` engine) — hops run strictly sequentially, the paper's
      plug-in arm;
    * ``None`` — sequential with every hop on the full (cloud) path;
    * :class:`~repro_torch.serving.scheduler.ContinuousBatchingScheduler` —
      ``run`` becomes a thin wrapper that builds the hop-graph trace and
      serves it, returning the same summary keys aggregated from the
      scheduler's per-complex-query records (plus pre-speculation
      telemetry).

    ``full_engine`` is the shared :class:`~repro_torch.retrieval.service.
    RetrievalService`; per-hop reasoning time comes from its
    ``LatencyModel.reason_scale`` unless ``reasoning_latency`` overrides
    it, so the sequential baseline and the scheduler path are charged
    identically.
    """

    def __init__(self, dataset: TwoHopDataset, engine, full_engine,
                 reasoning_latency: float | None = None):
        self.ds = dataset
        self.engine = engine          # HaS / scheduler (or None -> full)
        self.full = full_engine       # RetrievalService-backed full path
        self.reasoning_latency = (
            full_engine.latency.reason_time() if reasoning_latency is None
            else float(reasoning_latency))

    # -- sequential substrate ---------------------------------------------

    def _retrieve(self, q: dict):
        """One hop's retrieval, lexical terms threaded through BOTH paths
        (a HybridBackend cloud stage must never silently degrade to
        dense-only for agentic traffic)."""
        if self.engine is not None:
            ids, accept, lat, _ = self.engine.step(
                q["emb"], q_terms=q["terms"],
                q_term_weights=q["term_weights"])
            return ids, accept, lat
        ids, _, t = self.full.full_search(q["emb"], q["terms"],
                                          q["term_weights"])
        return ids, False, self.full.latency.sample_cloud() + t

    def _run_sequential(self, plans, dataset: str):
        recs = []
        for plan in plans:
            total_retrieval, accepts, hits = 0.0, [], []
            entity = plan.true_entity(1)
            for h in range(1, plan.hops + 1):
                q = plan.query(h, entity)
                ids, acc, lat = self._retrieve(q)
                total_retrieval += lat
                accepts.append(acc)
                hit = plan.hit(h, ids)
                hits.append(hit)
                if h < plan.hops:
                    entity = plan.bridge(h, hit)
            correct = plan.accuracy(all(hits), dataset)
            recs.append({
                "retrieval_latency": total_retrieval,
                "e2e_latency": (total_retrieval
                                + plan.hops * self.reasoning_latency),
                "dar": float(np.mean(accepts)),
                "accuracy": correct,
            })
        keys = recs[0].keys()
        return {k: float(np.mean([r[k] for r in recs])) for k in keys}

    # -- scheduler substrate ----------------------------------------------

    def _run_scheduled(self, plans, dataset: str, seed: int, arrivals):
        res = self.engine.serve([p.root_query() for p in plans],
                                arrivals=arrivals, dataset=dataset,
                                seed=seed)
        s = res.summary()
        out = {
            "retrieval_latency": s["complex_retrieval_avg_s"],
            "e2e_latency": s["complex_e2e_avg_s"],
            "dar": s["complex_dar"],
            "accuracy": s["complex_accuracy"],
            "hop2_prespec_rate": s["hop_prespec_rate"],
            "hop2_prespec_hit_rate": s["hop_prespec_hit_rate"],
        }
        out["sched_result"] = res
        return out

    def run(self, complex_queries, dataset: str = "granola", seed: int = 0,
            arrivals=None):
        """Execute the complex queries; returns mean retrieval/e2e
        latency, DAR and answer accuracy (same keys on every substrate).

        ``arrivals`` (scheduler substrate only) spaces the hop-1
        admissions on the virtual clock; ``None`` floods admission at
        t=0 like any saturated scheduler stream.
        """
        plans = decompose(self.ds, complex_queries, seed)
        from repro_torch.serving.scheduler import \
            ContinuousBatchingScheduler
        if isinstance(self.engine, ContinuousBatchingScheduler):
            return self._run_scheduled(plans, dataset, seed, arrivals)
        if arrivals is not None:
            raise ValueError("arrivals only applies to the scheduler "
                             "substrate")
        return self._run_sequential(plans, dataset)
