"""Port parity: the hash-map oracle of Algorithm 1 (``core/reference.py``).

The port's ``RefHas`` (a copy: numpy and collections) is held against the
reference's on one stream: cache-channel ids and scores, validation and
every update equal.  Then the port's fixed-shape ``core/has.py`` is held
against the port's ``RefHas`` per query, the twin of
``tests/test_has_core.py::test_algorithm1_equivalence_with_reference``:
live draft ids and accept bits equal.
"""
import numpy as np
import pytest

from repro.core.reference import RefHas as JaxRefHas
from repro.retrieval.ivf import build_ivf as ref_build_ivf
from repro_torch import convert
from repro_torch.core import has as pt_has
from repro_torch.core.reference import RefHas


def _stream(n, d, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(256, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    qs = rng.normal(size=(n, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return corpus, qs


@pytest.mark.parametrize("h_max,doc_cap", [(16, 128), (4, 12)])
def test_refhas_matches_reference_refhas(h_max, doc_cap):
    """Both oracles on one stream; the small case evicts from both FIFOs."""
    k, d = 5, 16
    corpus, qs = _stream(80, d, seed=h_max)
    ours = RefHas(k=k, tau=0.3, h_max=h_max, doc_cap=doc_cap)
    theirs = JaxRefHas(k=k, tau=0.3, h_max=h_max, doc_cap=doc_cap)
    for step, q in enumerate(qs):
        oi, os_ = ours.cache_channel(q)
        ti, ts = theirs.cache_channel(q)
        np.testing.assert_array_equal(oi, ti, err_msg=f"step {step}")
        np.testing.assert_array_equal(os_, ts, err_msg=f"step {step}")
        assert ours.validate(oi) == theirs.validate(ti), step
        if not ours.validate(oi)[0]:
            full = np.argsort(-(corpus @ q))[:k].astype(np.int32)
            ours.update(q, full, corpus[full])
            theirs.update(q, full, corpus[full])
        assert list(ours.doc_ids) == list(theirs.doc_ids), step
        assert [s for _, s in ours.queries] == \
            [s for _, s in theirs.queries], step
    assert len(ours.queries) == min(h_max, ours._qcounter)


def test_algorithm1_equivalence_with_port_refhas():
    """Fixed-shape HaS == the hash-map oracle, per query."""
    k, h_max, doc_cap, d = 5, 16, 128, 16
    cfg = pt_has.HasConfig(k=k, tau=0.3, h_max=h_max, doc_capacity=doc_cap,
                           nprobe=2, n_buckets=4, d=d,
                           use_fuzzy_validation=False,
                           use_fuzzy_enhancement=False)
    refi = RefHas(k=k, tau=0.3, h_max=h_max, doc_cap=doc_cap)
    state = pt_has.init_has_state(cfg, device="cpu")
    corpus, qs = _stream(60, d, seed=3)
    index = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_build_ivf(corpus, 4, seed=0), f))
         for f in convert.IVF_FIELDS}, device="cpu")
    accepts = []
    for step, q in enumerate(qs):
        out = pt_has.speculate(cfg, state, index, q, backend="torch")
        ref_ids, _ = refi.cache_channel(q)
        accept_ref, _ = refi.validate(ref_ids)
        live_got = sorted(int(i) for i in out["val_ids"] if i >= 0)
        live_ref = sorted(int(i) for i in ref_ids if i >= 0)
        assert live_got == live_ref, (step, live_got, live_ref)
        assert bool(out["accept"]) == accept_ref, step
        accepts.append(accept_ref)
        if not accept_ref:
            full = np.argsort(-(corpus @ q))[:k].astype(np.int32)
            pt_has.cache_update(cfg, state, q, full, corpus[full])
            refi.update(q, full, corpus[full])
    assert any(accepts) and not all(accepts)
