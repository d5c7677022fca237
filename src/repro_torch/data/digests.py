"""md5 digests of a synthetic world and its query streams.

The world and every stream are pure numpy draws from seeded Generators, so
two machines that build the same ``WorldConfig`` and ``sample_queries`` call
must hold byte-equal arrays.  These digests say whether they do, array by
array, without shipping the arrays: ``tests/test_torch_world_digests.py``
pins them and ``chip_smoke.py`` asserts them on the card.

``SIZES`` names the two configurations the checks cover: the quickstart
twin's (8000 entities, d=64) and configuration 1's (100,000 entities,
d=768, 500,000 passages), each with the granola stream of seed 1 whose
first 400 queries the full scan serves.  ``MARKOV_SIZES`` names the
training path's Markov LM sources (``data/lm.py``), pinned the same way:
``tests/test_torch_train_cli.py`` and ``chip_smoke.py`` phase 10a assert
them.
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.data.synthetic import zipf

#: name -> (WorldConfig kwargs, queries drawn, queries served by the scan)
SIZES = {
    "quickstart": (dict(n_entities=8000, d=64, seed=0), 1500, 400),
    "config1": (dict(n_entities=100_000, d=768, seed=0), 1500, 400),
}
GRANOLA = dict(pattern="zipf", zipf_a=1.12, p_uncovered=0.42)

#: the reference's digests (``repro.data.synthetic`` with numpy 2.0.2); the
#: port must build the same arrays wherever it runs
PINNED = {
    "quickstart": {
        "world": {"doc_emb": "71ef1893140c821183e6b35f3a7d11f8",
                  "entity_vecs": "0a72264cc68605feb653bb149424515a",
                  "attr_basis": "be83dbd0fd36ad3d4c4a250a68c8428c",
                  "doc_attr_mask": "5f15b542aca094aa97c373917abaffa0"},
        "stream": {"entities": "545168abe7602c2716017e7274b07722",
                   "attrs": "a85670a61a3bded4a9fa0555ec5ad2ae",
                   "embs": "c550db9ff65fd142ed6561f1c058e273"},
        "served": {"entities": "4db797126ec8300a645b04919896aaa2",
                   "attrs": "1a8663e127910f8f295de1b90134071a",
                   "embs": "a86e5af8afe000964f815694edcad856"}},
    "config1": {
        "world": {"doc_emb": "975a5efb72a6ff27ba6228a808113ae3",
                  "entity_vecs": "98be2f4fd16e0a0aeba764a37b571ea3",
                  "attr_basis": "781d239486cf98f50883cec3e3208e34",
                  "doc_attr_mask": "2ed64bd726101eddc3531fa6d53a1f2d"},
        "stream": {"entities": "5ad8361fa4f3c6ae74bd9f5740d16b8b",
                   "attrs": "9edb88bef6450a549c65ed10c593e3c0",
                   "embs": "15056ad0d99d5c47c7350b95fec51233"},
        "served": {"entities": "8e736e8713400d4f955e53fe0809fb42",
                   "attrs": "070ec129ed71be1c3bbd55c916200c5f",
                   "embs": "8377889f4959cd4c4e54ae655fe2a235"}},
}

#: name -> (vocab, batch, seq) of the Markov LM sources the checks cover:
#: ``launch/train.py``'s lm100m preset at the CLI's batch and sequence, and
#: ``examples/train_lm_torch.py``'s lm20m
MARKOV_SIZES = {"lm100m": (8192, 8, 128), "lm20m": (4096, 8, 128)}

#: the reference's digests (``repro.data.lm.MarkovLM(vocab, 2, seed=0)``'s
#: table and its first ``sample`` from ``default_rng(1)``, numpy 2.0.2)
MARKOV_PINNED = {
    "lm100m": {"probs": "0c4bb113ee49e8187e6918d4be596950",
               "tokens": "57ee0a5c0f6045cc260b633b484af4a8",
               "labels": "dcd0da9f32f914a99470a3069a6e8a1c"},
    "lm20m": {"probs": "ce28a9c7482f022d9cd016fa54fb2b8e",
              "tokens": "167e09b8fa1c5fd81750f94928b72e3b",
              "labels": "003a4fe17ed50229342b18a3840cbf71"},
}

#: ``default_rng(1).zipf(1.12, size=6000)[:4]``, the first draws of the
#: seed-1 stream, under numpy 2.0.2 (the reference) and numpy 2.3.5: they
#: part at the second draw
ZIPF_FIRST = {"numpy 2.0.2": (22, 2313896, 770, 117053),
              "numpy 2.3.5": (22, 1876569, 729, 102382)}


def md5(a) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.md5(a.dtype.str.encode() + str(a.shape).encode()
                       + a.tobytes()).hexdigest()


def world_digests(world) -> dict[str, str]:
    """The world's random arrays: ``doc_emb``, ``entity_vecs``,
    ``attr_basis`` and the doc-attr selection (``doc_attr_mask``)."""
    return {"doc_emb": md5(world.doc_emb),
            "entity_vecs": md5(world.entity_vecs),
            "attr_basis": md5(world.attr_basis),
            "doc_attr_mask": md5(world.doc_attr_mask)}


def stream_arrays(queries) -> dict[str, np.ndarray]:
    return {"entities": np.array([q["entity"] for q in queries], np.int64),
            "attrs": np.array([q["attr"] for q in queries], np.int64),
            "embs": np.stack([q["emb"] for q in queries]).astype(np.float32)}


def stream_digests(queries) -> dict[str, str]:
    return {k: md5(v) for k, v in stream_arrays(queries).items()}


def size_digests(world_cls, config_cls, size: str, world=None) -> dict:
    """Every digest of one of ``SIZES``, built with the given
    ``SyntheticWorld`` / ``WorldConfig`` classes (either package's);
    ``world`` is that size's world if it is already built."""
    kw, n, served = SIZES[size]
    if world is None:
        world = world_cls(config_cls(**kw))
    elif world.cfg != config_cls(**kw):
        raise ValueError(f"the world is not the {size} world")
    queries = world.sample_queries(n, **GRANOLA, seed=1)
    return {"world": world_digests(world),
            "stream": stream_digests(queries),
            "served": stream_digests(queries[:served])}


def mismatches(got: dict, want: dict, prefix: str = "") -> list[str]:
    """The keys (``size/part/array``) whose digests differ."""
    out = []
    for k, v in want.items():
        g = got.get(k) if isinstance(got, dict) else None
        if isinstance(v, dict):
            out += mismatches(g or {}, v, f"{prefix}{k}/")
        elif g != v:
            out.append(prefix + k)
    return out


def numpy_zipf_first_difference(n: int = 6000):
    """Where the installed numpy's own ``Generator.zipf`` leaves the
    port's version-independent sampler on the seed-1 stream's draw:
    (index, numpy's draw, the port's draw), or None where they agree."""
    own = np.random.default_rng(1).zipf(GRANOLA["zipf_a"], size=n)
    port = zipf(np.random.default_rng(1), GRANOLA["zipf_a"], size=n)
    return first_difference(own, port)


def first_difference(got: np.ndarray, want: np.ndarray):
    """(flat index, got value, wanted value) of the first element that
    differs, or None when the arrays are equal."""
    g, w = np.asarray(got).ravel(), np.asarray(want).ravel()
    if g.shape != w.shape:
        return ("shape", got.shape, want.shape)
    bad = np.flatnonzero(g != w)
    if not len(bad):
        return None
    i = int(bad[0])
    return (i, g[i].item(), w[i].item())


def markov_digests(markov_cls, size: str) -> dict[str, str]:
    """The digests of one of ``MARKOV_SIZES``, built with the given
    ``MarkovLM`` class (either package's), as ``train_lm`` draws its
    first batch."""
    vocab, batch, seq = MARKOV_SIZES[size]
    lm = markov_cls(vocab, 2, seed=0)
    first = lm.sample(np.random.default_rng(1), batch, seq)
    return {"probs": md5(lm.probs), "tokens": md5(first["tokens"]),
            "labels": md5(first["labels"])}
