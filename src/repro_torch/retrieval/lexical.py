"""Hashed-term helpers of the lexical channel (the world's postings).

The synthetic world has no real text, but its entity/attribute structure is
exactly what a lexical index would key on: the entity name and the queried
attribute.  Both are hashed into a flat term vocabulary at world-gen time —
pure integer hashing of arrays the world already has, consuming **zero**
rng draws, so dense embeddings and query streams stay bit-identical:

  * every doc posts its entity term (weight 1.0) plus one term per covered
    attribute (weight 0.7);
  * every query carries its entity term (weight 1.0) plus the queried
    (entity, attribute) term (weight 0.7).

Only the hashing lives here.  The lexical scoring kernel and the hybrid
cloud stage that read these postings are not part of the port yet.
"""
from __future__ import annotations

import numpy as np

LEXICAL_VOCAB = 1 << 20          # hashed term-id space
ENTITY_TERM_WEIGHT = 1.0
ATTR_TERM_WEIGHT = 0.7
_P_ENTITY = 2654435761           # Knuth multiplicative hash constants
_P_ATTR = 40503


def entity_term(entity) -> np.ndarray:
    """Hashed term id for an entity name (vectorized)."""
    return ((np.asarray(entity, np.int64) * _P_ENTITY)
            % LEXICAL_VOCAB).astype(np.int32)


def attr_term(entity, attr) -> np.ndarray:
    """Hashed term id for an (entity, attribute) pair (vectorized)."""
    e = np.asarray(entity, np.int64) * _P_ENTITY
    a = (np.asarray(attr, np.int64) + 1) * _P_ATTR
    return ((e ^ a) % LEXICAL_VOCAB).astype(np.int32)


def build_doc_terms(doc_entity: np.ndarray, doc_attr_mask: np.ndarray,
                    width: int | None = None):
    """Postings arrays for a corpus: -> (terms [N,L] int32 -1-padded,
    weights [N,L] f32).

    Slot 0 is the entity term; the remaining slots are the covered
    attributes' pair terms in ascending attribute order.  ``width`` caps L:
    narrower postings drop the highest-numbered attributes.  Deterministic
    in the inputs — no rng.
    """
    n, _ = doc_attr_mask.shape
    max_attrs = int(doc_attr_mask.sum(axis=1).max()) if n else 0
    l_w = (1 + max_attrs) if width is None else max(1, int(width))
    terms = np.full((n, l_w), -1, np.int32)
    weights = np.zeros((n, l_w), np.float32)
    terms[:, 0] = entity_term(doc_entity)
    weights[:, 0] = ENTITY_TERM_WEIGHT
    # covered attrs first (ascending attr id) per row, without a python loop
    order = np.argsort(~doc_attr_mask, axis=1, kind="stable")
    counts = doc_attr_mask.sum(axis=1)
    for j in range(l_w - 1):
        has = counts > j
        t = attr_term(doc_entity, order[:, j])
        terms[has, 1 + j] = t[has]
        weights[has, 1 + j] = ATTR_TERM_WEIGHT
    return terms, weights


def query_terms(entity: int, attr: int):
    """Hashed query terms -> (terms [2] int32, weights [2] f32)."""
    return (np.array([entity_term(entity), attr_term(entity, attr)],
                     np.int32),
            np.array([ENTITY_TERM_WEIGHT, ATTR_TERM_WEIGHT], np.float32))
