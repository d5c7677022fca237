"""Port parity: synthetic world, lexical hashing, latency model, dispatch.

The port's world must be byte-identical to the reference's for the same
config and seed (same numpy rng, same draw order).
"""
import numpy as np
import pytest

from repro.data import synthetic as ref_syn
from repro.retrieval import lexical as ref_lex
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch.core import dispatch
from repro_torch.data import synthetic as pt_syn
from repro_torch.retrieval import lexical as pt_lex
from repro_torch.serving.latency import LatencyModel as PtLatency

WORLD_ARRAYS = ("entity_vecs", "attr_basis", "doc_entity", "doc_attr_mask",
                "doc_emb", "entity_attrs", "doc_terms", "doc_term_weights")


def _worlds(**kw):
    return (ref_syn.SyntheticWorld(ref_syn.WorldConfig(**kw)),
            pt_syn.SyntheticWorld(pt_syn.WorldConfig(**kw)))


@pytest.mark.parametrize("kw", [
    dict(n_entities=150, d=32, seed=0),
    dict(n_entities=97, d=48, seed=3, **pt_syn.ENCODERS["bge-large"]),
])
def test_world_arrays_byte_identical(kw):
    ref, pt = _worlds(**kw)
    for name in WORLD_ARRAYS:
        a, b = getattr(ref, name), getattr(pt, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("dataset", ["granola", "popqa", "triviaqa"])
def test_query_streams_byte_identical(dataset):
    ref, pt = _worlds(n_entities=150, d=32, seed=0)
    ds = ref_syn.DATASETS[dataset]
    args = dict(pattern=ds["pattern"], zipf_a=ds["zipf_a"],
                p_uncovered=ds["p_uncovered"], seed=1)
    qa = ref.sample_queries(60, **args)
    qb = pt.sample_queries(60, **args)
    assert len(qa) == len(qb) == 60
    for x, y in zip(qa, qb):
        assert (x["entity"], x["attr"]) == (y["entity"], y["attr"])
        for key in ("emb", "tokens", "terms", "term_weights"):
            assert x[key].dtype == y[key].dtype, key
            assert x[key].tobytes() == y[key].tobytes(), key


def test_scattered_stream_and_golden_mask():
    ref, pt = _worlds(n_entities=80, d=16, seed=2)
    qa = ref.sample_queries(20, pattern="scattered", seed=5)
    qb = pt.sample_queries(20, pattern="scattered", seed=5)
    ids = np.array([0, 3, -1, 17, 250, 399])
    for x, y in zip(qa, qb):
        assert x["emb"].tobytes() == y["emb"].tobytes()
        np.testing.assert_array_equal(
            ref.golden_mask(x["entity"], x["attr"], ids),
            pt.golden_mask(y["entity"], y["attr"], ids))


def test_response_accuracy_draws_identical():
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for hit, n in [(True, 10), (False, 10), (True, 14), (False, 3)]:
        for llm in ("qwen3-8b", "llama3-8b"):
            assert ref_syn.simulate_response_accuracy(ra, hit, "granola",
                                                      llm, n) == \
                pt_syn.simulate_response_accuracy(rb, hit, "granola", llm, n)


def test_lexical_hashing_identical():
    ent = np.arange(0, 5000, 7)
    attr = ent % 12
    np.testing.assert_array_equal(ref_lex.entity_term(ent),
                                  pt_lex.entity_term(ent))
    np.testing.assert_array_equal(ref_lex.attr_term(ent, attr),
                                  pt_lex.attr_term(ent, attr))
    rng = np.random.default_rng(0)
    mask = rng.random((64, 12)) < 0.3
    doc_ent = rng.integers(0, 1000, 64)
    for width in (None, 3):
        for a, b in zip(ref_lex.build_doc_terms(doc_ent, mask, width),
                        pt_lex.build_doc_terms(doc_ent, mask, width)):
            assert a.tobytes() == b.tobytes()
    for a, b in zip(ref_lex.query_terms(12, 5), pt_lex.query_terms(12, 5)):
        assert a.tobytes() == b.tobytes()


def test_latency_model_identical():
    a, b = RefLatency(seed=3), PtLatency(seed=3)
    for m in (a, b):
        m.d, m.actual_corpus = 768, 500_000
        m.calibrate(0.01, 500_000)
    assert [a.sample_edge() for _ in range(5)] + \
        [a.sample_cloud() for _ in range(5)] == \
        [b.sample_edge() for _ in range(5)] + \
        [b.sample_cloud() for _ in range(5)]
    assert a.full_scan_time() == b.full_scan_time()
    assert a.ann_scale(8192, 64) == b.ann_scale(8192, 64)
    assert a.shard_scale(4) == b.shard_scale(4)
    assert a.ingest_time(3, 50_000, 10) == b.ingest_time(3, 50_000, 10)
    assert a.hybrid_scale(1.0, 5, 20) == b.hybrid_scale(1.0, 5, 20)


def test_dispatch_capture_counts():
    with dispatch.capture() as probe:
        dispatch.record("speculate_batch")
        dispatch.record("cache_update")
        dispatch.record("cache_update")
    assert probe.counts() == {"speculate_batch": 1, "cache_update": 2}
    assert probe.total() == 3
