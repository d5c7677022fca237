"""The traffic generator: one seed, one world and stream; the Zipf loop
draws what the port's ``data/synthetic.py::zipf`` draws."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from perfbench.traffic import generator

CFG = json.loads((ROOT / "perfbench/configs/has-flat.json").read_text())
CFG.update(d=32)
CFG["world"] = dict(CFG["world"], n_entities=3000)


def _mix(name):
    return json.loads((ROOT / f"perfbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("a", [1.01, 1.12, 1.3])
def test_zipf_draws_as_the_port_draws(a):
    from repro_torch.data.synthetic import zipf as port_zipf
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    assert np.array_equal(generator.zipf(r1, a, 5000),
                          port_zipf(r2, a, size=5000))
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("mix", ["granola", "squad"])
def test_same_seed_same_world_and_stream(mix):
    seed = 2 ** 31 + 12345
    out = []
    for _ in range(2):
        w = generator.make_world(CFG, seed, "cpu")
        s = generator.make_stream(w, CFG, _mix(mix), seed, 512)
        out.append((w.corpus.clone(), s))
    (c1, s1), (c2, s2) = out
    assert torch.equal(c1, c2)
    assert np.array_equal(s1.emb, s2.emb)
    assert np.array_equal(s1.entity, s2.entity)
    assert np.array_equal(s1.attr, s2.attr)
    w3 = generator.make_world(CFG, seed + 1, "cpu")
    assert not torch.equal(c1, w3.corpus)


def test_world_shapes_and_unit_rows():
    w = generator.make_world(CFG, 3, "cpu")
    n = CFG["world"]["n_entities"] * CFG["world"]["docs_per_entity"]
    assert w.corpus.shape == (n, 32)
    assert torch.allclose(w.corpus.norm(dim=1), torch.ones(n), atol=1e-5)
    # each document covers attrs_per_doc attributes of its entity
    assert w.entity_attrs.sum(axis=1).min() >= CFG["world"]["attrs_per_doc"]


def test_stream_follows_the_mix():
    w = generator.make_world(CFG, 5, "cpu")
    s = generator.make_stream(w, CFG, _mix("granola"), 5, 4096)
    # a Zipf head: the most frequent entity takes a large share
    top = np.bincount(s.entity).max() / len(s.entity)
    assert top > 0.05
    uncovered = ~w.entity_attrs[s.entity, s.attr]
    assert 0.0 < uncovered.mean() < 0.42 * 1.35
    assert s.emb.shape == (4096, 32) and s.emb.dtype == np.float32


def test_stream_length_counts_the_fill_window_and_extra_steps():
    mix = dict(_mix("squad"), fill_queries=1000, max_qps=100, batch=64)
    assert generator.stream_length(mix, 2.0, 3) == 1408
