"""The synthetic world and its query streams are the same arrays in the
reference and the port, and the same wherever the port runs.

The quickstart size (8000 entities, d=64, the granola stream of seed 1)
is built live by both packages here: every digest equal between them and
to the pinned constants of ``repro_torch.data.digests``.  Configuration
1's digests (100,000 entities, d=768) are pinned from one reference build
on numpy 2.0.2; a 1.5 GB world is too costly to build in these tests, and
``chip_smoke.py`` asserts them on the card.

numpy changed ``Generator.zipf`` after 2.0 (numpy 2.3.5 draws
another second rank from seed 1), so the port samples Zipf ranks with
numpy 2.0.2's rejection loop over the Generator's own uniforms
(``repro_torch.data.synthetic.zipf``), held here to pinned draws.
"""
import numpy as np
import pytest

from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro_torch.data import digests
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.data.synthetic import zipf


@pytest.fixture(scope="module")
def quickstart():
    return (digests.size_digests(RefWorld, RefWorldCfg, "quickstart"),
            digests.size_digests(PtWorld, PtWorldCfg, "quickstart"))


@pytest.mark.parametrize("part", ["world", "stream", "served"])
def test_quickstart_digests_equal_between_packages_and_pinned(quickstart,
                                                              part):
    ref, pt = quickstart
    assert ref[part] == pt[part]
    assert pt[part] == digests.PINNED["quickstart"][part]
    assert not digests.mismatches(pt, digests.PINNED["quickstart"])


def test_config1_digests_are_pinned():
    pinned = digests.PINNED["config1"]
    assert set(pinned) == {"world", "stream", "served"}
    assert set(pinned["world"]) == {"doc_emb", "entity_vecs", "attr_basis",
                                    "doc_attr_mask"}
    for part in ("stream", "served"):
        assert set(pinned[part]) == {"entities", "attrs", "embs"}
    flat = [v for p in pinned.values() for v in p.values()]
    assert len(set(flat)) == len(flat)
    assert all(len(v) == 32 and int(v, 16) >= 0 for v in flat)
    kw, n, served = digests.SIZES["config1"]
    assert PtWorldCfg(**kw).n_docs == 500_000 and (n, served) == (1500, 400)


def test_mismatches_names_the_arrays_that_differ():
    want = digests.PINNED["quickstart"]
    got = {p: dict(v) for p, v in want.items()}
    got["stream"]["entities"] = "0" * 32
    del got["world"]["doc_emb"]
    assert digests.mismatches(got, want) == ["world/doc_emb",
                                             "stream/entities"]


@pytest.mark.parametrize("seed,a,n", [(1, 1.12, 6000), (7, 1.3, 5000),
                                      (3, 1.04, 5000), (9, 1.01, 3000),
                                      (0, 2.5, 500)])
def test_zipf_replays_numpy_2_0_draws_and_leaves_the_state(seed, a, n):
    """Against the installed numpy where it is 2.0.x, else against the
    pinned first draws; either way the Generator ends where numpy 2.0's
    loop leaves it (the pinned next uniform of the seed-1 stream)."""
    rng = np.random.default_rng(seed)
    got = zipf(rng, a, size=n)
    assert got.dtype == np.int64 and got.shape == (n,) and got.min() >= 1
    nxt = rng.random()
    if np.__version__.startswith("2.0."):
        own = np.random.default_rng(seed)
        np.testing.assert_array_equal(own.zipf(a, size=n), got)
        assert own.random() == nxt
    if (seed, a) == (1, 1.12):
        assert tuple(got[:4]) == digests.ZIPF_FIRST["numpy 2.0.2"]
        assert nxt == 0.5720896119471776


def test_zipf_scalar_and_bad_exponent():
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    one = zipf(r1, 1.15)
    assert isinstance(one, int) and one == int(zipf(r2, 1.15, size=1)[0])
    with pytest.raises(ValueError):
        zipf(r1, 1.0)


def test_first_difference():
    assert digests.first_difference(np.arange(4), np.arange(4)) is None
    assert digests.first_difference(np.array([1, 2, 3]),
                                    np.array([1, 5, 3])) == (1, 2, 5)
    got = digests.numpy_zipf_first_difference()
    if np.__version__.startswith("2.0."):
        assert got is None
