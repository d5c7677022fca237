"""Port parity of RAG serving: ``serve_rag`` against the reference's loop.

The request loop of ``examples/rag_serving.py`` (HaS retrieval, the prompt
rule, prefill, a fresh KV cache, greedy decode) is replayed here with the
JAX package, in f32, on a small world, and the port's ``serve_rag``
(``device="cpu"``) serves the same queries with the reference's IVF index
and generator weights carried across.  Retrieval ids, accept bits and every
generated token must be equal: with the dense generator, with a tiny MoE
generator (8 experts, top-2, Arctic's dense residual; decode capacity 3,
so experts overflow and drop), and through ``examples/rag_serving_torch.py``
at its own sizes (5000 entities, the ``rag-lm`` generator, 16 requests).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import DATASETS
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.models import transformer as rtf
from repro.serving.engine import HasEngine as RefHas
from repro.serving.engine import RetrievalService as RefService
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch import convert
from repro_torch.core.has import HasConfig as PtCfg
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.models import transformer as tf
from repro_torch.retrieval.service import RetrievalService as PtService
from repro_torch.serving.engine import HasEngine as PtHas
from repro_torch.serving.latency import LatencyModel as PtLatency
from repro_torch.serving.rag import build_prompt, serve_rag

WORLD = dict(n_entities=300, d=32, seed=0)
CFG = dict(k=10, tau=0.2, h_max=64, nprobe=4, n_buckets=32, d=32)
GEN = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=4096, d_head=16)
GEN_MOE = dict(GEN, moe_experts=8, moe_top_k=2, moe_dense_residual=True)
BATCH, PROMPT_LEN, GEN_LEN, N_REQ = 8, 64, 6, 24
ROOT = Path(__file__).resolve().parents[1]


def _twin():
    spec = importlib.util.spec_from_file_location(
        "rag_serving_torch", ROOT / "examples" / "rag_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_loop(engine, params, cfg, queries, prompt_len=PROMPT_LEN,
                    gen_len=GEN_LEN):
    """``examples/rag_serving.py:61-92`` in f32, recording what it drops."""
    ids_all, accepts, tokens = [], [], []
    for start in range(0, len(queries), BATCH):
        group = queries[start:start + BATCH]
        if len(group) < BATCH:
            break
        doc_ids = []
        for q in group:
            ids, accept, _, _ = engine.step(q["emb"])
            accepts.append(accept)
            doc_ids.append(ids[:10])
        ids_all.extend(doc_ids)
        prompt = np.zeros((BATCH, prompt_len), np.int64)
        for i, (q, ids) in enumerate(zip(group, doc_ids)):
            ctx = (np.abs(ids) % 4000).repeat(5)[:prompt_len - 8]
            prompt[i, :len(ctx)] = ctx
            prompt[i, -8:] = (q["tokens"] % 4000)[:8].repeat(2)[:8]
        prompt = jnp.asarray(prompt, jnp.int32)
        logits = rtf.prefill(params, prompt, cfg, compute_dtype=jnp.float32)
        cache = rtf.init_kv_cache(cfg, BATCH, prompt_len + gen_len,
                                  jnp.float32)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        row = [np.asarray(tok)]
        for j in range(gen_len):
            lg, cache = rtf.decode_step(params, cache, tok,
                                        jnp.int32(prompt_len + j), cfg,
                                        compute_dtype=jnp.float32)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            row.append(np.asarray(tok))
        tokens.append(np.stack(row, 1))
    return (np.stack(ids_all), np.asarray(accepts), np.concatenate(tokens))


def _serve(gen):
    """Both engines on one world, the reference's index and ``gen``'s
    reference weights handed to the port; both loops over one stream."""
    rw, pw = RefWorld(RefWorldCfg(**WORLD)), PtWorld(PtWorldCfg(**WORLD))
    ds = DATASETS["granola"]
    queries = rw.sample_queries(N_REQ + 3, pattern=ds["pattern"],
                                zipf_a=ds["zipf_a"],
                                p_uncovered=ds["p_uncovered"], seed=1)
    ref_eng = RefHas(RefService(rw, RefLatency(), k=10), RefCfg(**CFG),
                     backend="xla")
    index = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_eng.index, f))
         for f in convert.IVF_FIELDS}, device="cpu")
    pt_eng = PtHas(PtService(pw, PtLatency(), k=10, device="cpu"),
                   PtCfg(**CFG), backend="torch", index=index)
    rcfg = rtf.TransformerConfig(name="rag-lm", remat=False, **gen)
    pcfg = tf.TransformerConfig(name="rag-lm", **gen)
    rparams = rtf.init_params(rcfg, jax.random.key(0))
    pparams = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, rparams), pcfg, device="cpu",
        dtype=torch.float32)
    ref = _reference_loop(ref_eng, rparams, rcfg, queries)
    res = serve_rag(pt_eng, queries, pparams, pcfg, batch=BATCH,
                    prompt_len=PROMPT_LEN, gen_len=GEN_LEN, device="cpu")
    return dict(queries=queries, ref=ref, res=res, rparams=rparams,
                rcfg=rcfg, pparams=pparams, pcfg=pcfg)


@pytest.fixture(scope="module")
def served():
    return _serve(GEN)


def test_serve_rag_matches_reference_loop(served):
    ref_ids, ref_acc, ref_tok = served["ref"]
    res = served["res"]
    assert res.ids.shape == (N_REQ, 10)          # the partial batch dropped
    np.testing.assert_array_equal(res.ids, ref_ids)
    np.testing.assert_array_equal(res.accepts, ref_acc)
    assert 0 < res.accepts.sum() < N_REQ          # both branches exercised
    assert res.tokens.shape == (N_REQ, GEN_LEN + 1)
    np.testing.assert_array_equal(res.tokens, ref_tok)
    assert len(res.ttft_s) == len(res.decode_tps) == N_REQ // BATCH
    s = res.summary()
    assert s["requests"] == N_REQ and s["decode_tps_avg"] > 0


def test_decode_starts_from_a_zero_cache(served):
    """The reference's quirk, copied: decode does not see the prefill's K/V.
    Its first step over a fresh cache at position prompt_len leaves rows
    < prompt_len zero, writes row prompt_len, and gives the reference's
    logits; a cache holding the prompt's K/V would give others."""
    res, q = served["res"], served["queries"][:BATCH]
    prompt = build_prompt(q, res.ids[:BATCH], PROMPT_LEN)
    pcfg, pparams = served["pcfg"], served["pparams"]
    tok = torch.tensor(res.tokens[:BATCH, 0])
    cache = tf.init_kv_cache(pcfg, BATCH, PROMPT_LEN + GEN_LEN,
                             torch.float32, device="cpu")
    lg, cache = tf.decode_step(pparams, cache, tok, PROMPT_LEN, pcfg)
    assert not cache["k"][:, :, :PROMPT_LEN].any()
    assert not cache["v"][:, :, :PROMPT_LEN].any()
    assert cache["k"][:, :, PROMPT_LEN].abs().sum() > 0
    rcache = rtf.init_kv_cache(served["rcfg"], BATCH, PROMPT_LEN + GEN_LEN,
                               jnp.float32)
    rlg, _ = rtf.decode_step(served["rparams"], rcache,
                             jnp.asarray(res.tokens[:BATCH, 0]),
                             jnp.int32(PROMPT_LEN), served["rcfg"],
                             compute_dtype=jnp.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=2e-4,
                               atol=2e-4)
    # with the prompt's K/V in the cache the first step would differ
    full = tf.forward(pparams, torch.cat(
        [torch.tensor(prompt), tok[:, None]], dim=1), pcfg)[0][:, -1]
    assert (full - lg).abs().max() > 1e-3
    np.testing.assert_array_equal(res.tokens[:BATCH, 1],
                                  lg.argmax(-1).numpy())


def test_serve_rag_rejects_mixed_devices(served):
    class OnCuda:
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="engine"):
        serve_rag(OnCuda(), served["queries"], served["pparams"],
                  served["pcfg"], device="cpu")


def test_serve_rag_with_an_moe_generator_matches_reference_loop():
    """``serve_rag`` takes an MoE config unchanged: the same warm-up, the
    same fresh-cache decode; ids, accepts and every token equal."""
    got = _serve(GEN_MOE)
    ref_ids, ref_acc, ref_tok = got["ref"]
    res = got["res"]
    assert got["pcfg"].is_moe
    assert int(1.25 * BATCH * 2 / 8) + 1 == 3     # decode capacity: drops
    np.testing.assert_array_equal(res.ids, ref_ids)
    np.testing.assert_array_equal(res.accepts, ref_acc)
    np.testing.assert_array_equal(res.tokens, ref_tok)
    assert len(np.unique(res.tokens)) > 1


def test_rag_twin_matches_reference_loop_and_prints_its_lines(capsys):
    """``examples/rag_serving_torch.py`` at its own sizes: with the
    reference's index and its ``jax.random.key(0)`` generator handed over
    (f32), ids, accepts and tokens equal the reference's loop; ``main``
    with ``--device cpu`` prints the reference's lines."""
    twin = _twin()
    n = 16
    rw = RefWorld(RefWorldCfg(n_entities=twin.N_ENTITIES, seed=0))
    ds = DATASETS["granola"]
    queries = rw.sample_queries(n, pattern=ds["pattern"],
                                zipf_a=ds["zipf_a"],
                                p_uncovered=ds["p_uncovered"], seed=1)
    ref_eng = RefHas(RefService(rw, RefLatency(), k=10),
                     RefCfg(**twin.HAS_CFG))
    index = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_eng.index, f))
         for f in convert.IVF_FIELDS}, device="cpu")
    cfg = twin.GEN_CFG
    rcfg = rtf.TransformerConfig(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size, d_head=cfg.d_head, remat=False)
    assert rcfg.param_count() == cfg.param_count()
    rparams = rtf.init_params(rcfg, jax.random.key(0))
    pparams = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu",
        dtype=torch.float32)
    ref_ids, ref_acc, ref_tok = _reference_loop(
        ref_eng, rparams, rcfg, queries, twin.PROMPT_LEN, twin.GEN_LEN)
    out = twin.run(n, device="cpu", params=pparams, index=index)
    res = out["result"]
    assert out["device"] == "cpu"
    np.testing.assert_array_equal(res.ids, ref_ids)
    np.testing.assert_array_equal(res.accepts, ref_acc)
    assert res.tokens.shape == (n, twin.GEN_LEN + 1)
    np.testing.assert_array_equal(res.tokens, ref_tok)

    capsys.readouterr()
    got = twin.main([str(n), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    heads = ["generator: ", "requests served ", "retrieval avg latency ",
             "prefill TTFT (batch) ", "decode throughput ", "",
             "Fig-1 takeaway: full-DB retrieval would add "]
    assert len(lines) == len(heads)
    for line, head in zip(lines, heads):
        assert line.startswith(head), (line, head)
    assert lines[0] == f"generator: {cfg.param_count() / 1e6:.1f}M params"
    assert lines[1] == f"requests served        {n}"
    res = got["result"]
    assert res.tokens.shape == (n, twin.GEN_LEN + 1)
    assert ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all()
