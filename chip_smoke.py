"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # from the root of the repository

Phases (any failure exits non-zero; no phase catches and carries on):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   both TF32 flags (TF32 must stay off: the port's f32 products are full
   f32);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel) while the two synthetic worlds
   are built: the ``world_digests`` line (numpy's version, the md5s of
   ``doc_emb``, ``entity_vecs``, ``attr_basis``, the doc-attr selection and
   the granola stream's entities, attrs and embeddings, at the quickstart
   twin's size and configuration 1's), asserted equal to the reference's
   pinned digests (``repro_torch/data/digests.py``);
3. hold each of the eight kernels against its plain PyTorch version at the
   main-path shapes (B=1 and B=64; the tenant path's B=32 shapes: grouped
   topk_search over 4 x 50,000 rows, ivf_scan at P=64, grouped
   homology_validate over 4 x 5000 rows with an empty tenant; the
   scheduler's: topk_search B=32 over one 50,000-row ring,
   homology_validate B=16 with padded rows (re-validation), homology_score
   288 x 288 drafts against themselves (sharing); phase 9's: ivf_scan f32
   and int8 at B=16, P=32 over 1024 buckets of cap 977 (``IVFBackend``)
   and of the rebuilt cap, lexical_score at B=16 over the grown
   postings);
   topk_search also at B=7 and B=65 and at k=1 and k=100; ivf_scan in
   both modes also at B=7 and 65, k=1 and MAX_K, P=1 and 512, a pool
   smaller than k, all-pad pools, clamped probes, a tie between two probes, d=770, 200 calls back to back and
   two streams, one launch per call; decode attention at the RAG shape
   for chatglm3-6b's G=16 and the G=4 and G=9 of the other dense configs,
   the MoE configs' G=6 (dbrx-132b) and G=7 (arctic-480b) at Hkv=8 (each
   timed), decode_32k and long_500k; the EmbeddingBag at the deepfm and dlrm-rm2
   Criteo tables, B=512 (int32 and int64 ids, bf16 tables of even and odd
   d; one launch a call, and each call's host and device time beside
   F.embedding_bag's); lexical_score at B=1, 64, 65 and 200 (two
   launches), k=1 and MAX_K, shared and repeated terms, tie-heavy postings
   that overflow the kernel's hit list, matches that fill its global list
   (fast and slow rounds mixed), tile_n 99, 256 and 512, 200 calls back to
   back and two streams, one launch a call; homology_validate (scores,
   best row, its score) at B=1, 64, 200, k=1, 10, 32 and a generic k,
   weighted, grouped, ties across CTAs, 200 calls back to back and two
   streams; fused_rerank with
   its final top-k at B=1, 64, 65, P=1, 20, 64, k=1, 10 and > P; both one
   launch a call, each beside the split sequence (the reduction in
   launches of its own after the kernel), and
   fused_rerank's phases from ``kernels/fused_rerank_probe.py``'s traced
   build) and at edge cases; time kernel, plain version,
   library call and the bound; print ptxas's registers and spills per
   kernel and the dynamic shared memory of the redesigned ones; then the
   tables' lookup path: fresh B=512 batches through ``embedding_bag_op``
   with its count set to 0 before; the tables are freed before the world
   is built;
4. Algorithm 1 (``FullRetrievalEngine`` on 400 queries, ``HasEngine`` on
   1500) at d=768, h_max=5000, doc_cap=50,000, 8192 IVF buckets / nprobe
   64, over 500,000 synthetic passages (100,000 entities); the launch
   counts are set to 0 before it and read after: topk_search, ivf_scan and
   homology_score must each be > 0; then a profiled window of 100 fresh
   queries, once as the port runs it and once split (the same kernels,
   with validation's argmax and gather and the cloud stage's two sorts in
   launches of their own), from one cache snapshot, and a 300-query replay with
   ``backend="torch"`` on the same index (accept bits equal, ids equal up
   to near-ties);
5. the hybrid cloud stage on the same world: ``HybridBackend`` (dense
   "ann": 1024 clusters, nprobe 32, int8 residual codes; lexical top-10
   over 512-row tiles; RRF k=60, diversify 0.98) under
   ``FullRetrievalEngine`` (400 queries) and ``HasEngine(fusion="rrf")``
   (1500), query terms forwarded; the counts are set to 0 before it and all
   six retrieval kernels must be > 0 after; then a profiled window and a 300-query
   replay with ``backend="torch"`` for speculation and cloud stage (accept
   bits equal, ids equal up to near-ties proven by recomputation);
6. the RAG generator (``examples/rag_serving.py``'s path): chatglm3-6b at
   full width, all 28 layers, bf16, random weights from ``init_params`` on
   the card, behind a fresh ``HasEngine`` on phase 4's world and index:
   ``serve_rag`` over 64 requests, batch 8, prompt 2048, 64 greedy decode
   steps; the counts are set to 0 before it and ``decode_attention`` must
   launch exactly 28 x 64 x 8 times (layers x steps x batches); then one batch's decode window under
   the profiler, and that batch replayed with each backend, its greedy
   tokens equal except at proven near-ties of the logits;
6b. the MoE generators at full width, random bf16 weights, behind a fresh
   ``HasEngine`` on the same world and index: dbrx-132b with 4 of its 40
   layers, then (dbrx freed) arctic-480b with 2 of its 35, each through
   ``serve_rag`` over 16 requests (batch 8, prompt 2048, 64 greedy steps);
   ``decode_attention`` must launch exactly layers x 64 x 2 times and the
   retrieval kernels > 0; one batch's decode window and one prefill
   profiled; the routing of every decode step recorded (dropped (token,
   slot) pairs, zeroed slot-0 tokens, capacity); layer 0 of decode step 0
   held against a plain f32 loop over each token's routed experts
   (``MOE_TOL``); the batch replayed with ``backend="torch"`` fed the
   kernel run's tokens, rows compared while their routing agrees (logit
   and routing near-ties proven); init time and peak memory;
7. the micro-batched engine (``BatchedHasEngine``, ``batch_size=32``) on
   phase 4's world, index and 1500 queries, then with 4 tenants on
   ``sweep_tenants``' stream (entity % 4 == t, 400 queries per tenant,
   round-robin; h_max and doc_cap per tenant); the counts are set to 0
   before each and topk_search, ivf_scan and homology_score must be > 0
   after; ``intra_batch_share`` on the rejected drafts of 20 tenant
   micro-batches, backend "cuda" equal to "torch" and no follower across
   tenants; the leakage audit with fuzzy validation and enhancement off
   (0 leaked ids); 300 queries of each run replayed with
   ``backend="torch"`` from the same empty cache; a profiled window of 10
   fresh micro-batches; ``ANNSEngine`` ("ivf", "scann": 4096 buckets,
   nprobe 64; the "ivf" ids of 300 queries against the plain scan's) and
   ``HasEngine(fallback=ANNSEngine("ivf"))`` on 400 queries;
   ``examples/quickstart_torch.py`` and ``examples/rag_serving_torch.py``
   at their own sizes;
8. the continuous-batching scheduler (``examples/async_serving.py``'s
   path, ``SchedulerConfig(max_spec_batch=32, full_batch=16,
   full_max_wait_s=0.05)``) on phase 4's world, index and 1500 queries:
   saturated (every request at t=0), with the counts set to 0 before and
   topk_search, ivf_scan and homology_score > 0 after, ten speculation
   dispatches (speculate_batch at B=32 and the sharing election over 288
   rows) profiled one by one, and a ``backend="torch"`` replay (channels,
   accepts, served ids, leader_idx, replica ids, t_done and every span
   equal); Poisson arrivals at the reference's qps_saturating (32 /
   ``_spec_time(32)``); 4 tenants on phase 7's stream (leakage audit with
   fuzzy V and E off: 0 leaked ids, 0 cross-tenant followers; a torch
   replay); three edge replicas under a fault plan with every kind, timed
   off the fault-free makespan (the cloud events on the lone
   ``LocalFlatBackend`` worker); ``shed`` and ``degrade`` at 4x the edge
   rate with the SLO at 2.5x the unloaded reject path.  Every run: spans
   conserved within 1e-9 s and none negative, every full and shared
   result folded once (the rings' pointers count them);
   then the full scan's DocHit on configuration 1's and the quickstart
   twin's 400 queries, asserted equal to the CPU reference's;
9. the cloud backends on configuration 1's world, each path with the
   counts set to 0 before it and read after: (a) ``ShardedMeshBackend``
   (4 shards, 4 workers) against the flat scan on 400 queries (ids equal
   in every row), then the saturated scheduler over it and a torch
   replay; (b) ``HybridBackend(dense="sharded")`` under the full engine
   and ``HasEngine(fusion="rrf")`` (400 queries) and a 300-query torch
   replay; (c) live ingest into ``IVFBackend`` f32 and int8 (1024
   clusters, nprobe 32, residual_cap 1024) and ``HybridBackend(dense=
   "ann")`` with terms: one doc twice under one key, 2048 new passages,
   a 4096-doc flood near centroid 0 that spills and rebuilds; after each,
   64 queries with the kernels against torch, and at the end every held
   doc found by its own embedding; (d) ``ReplicaBackend`` with two warm
   standbys under the saturated scheduler: each log holds every folded
   row once, and a failover equals the primary's rings; (e) 900 two-hop
   complex queries: the sequential ``AutoRagPipeline`` (full, HaS) and
   the scheduler with ``speculate_hops`` on and off, each replayed with
   torch; (f) ``repro_torch.launch.serve.main`` with the scheduler and 25%
   agentic traffic for each cloud backend, and two flag sets that exit 2;
10. the LM training path, after the earlier phases' worlds, indexes and
   weights are freed (the memory still allocated is printed): (a)
   ``repro_torch.launch.train.main`` on the lm100m preset, 200 steps with
   checkpoints, then 20 more resumed from step 200, both within
   ``RESUME_TOL`` of an uninterrupted 220-step run, the loss falling, the
   ``MarkovLM`` digests asserted first; (b) chatglm3-6b at full width, 15
   of 28 layers, f32 masters, bf16 compute, remat "full", AdamW, steps of
   4 micro-batches of 2 x 4096 tokens (``make_train_step_accum``), after
   checks at 2 layers: remat none / "full" / "dots" equal (each policy's
   peak memory), accumulation equal to one 8-sequence step in f32, the
   bf16 loss near the f32 loss; (c) dbrx-132b at full width, 2 of 40
   layers, bf16 masters with an f32 router, Adafactor in the reference's
   stacked shapes, one 4096-token sequence a step, the routing that remat
   recomputes in the backward equal to the forward's.  Each reports step
   time, tokens/s, model TFLOP/s against 989, peak memory, one profiled
   step's busy time and idle share, and the optimizer alone.  The eight
   kernels' counts are set to 0 before phase 10 and must read 0 after:
   training launches none of them;
11. the registry and the remaining model families, on a card freed of
   phase 10's memory, while three worker processes draw the large numpy
   batches (seed 0): (a) the registry's eleven archs, each of the ten
   trainable ones through ``launch.train.main --arch`` for 3 steps on the
   card (finite losses), ``--arch has-rag`` raising ``ValueError``, the
   ``ClickLog`` / ``SessionLog`` / ``make_graph_batch`` digests, and the
   recsys and DimeNet smokes' forward, loss and gradients on the card
   within ``SMOKE_TOL`` of the CPU's on the same weights (has-rag's smoke
   ids and accept equal); (d) the batched HaS step at ``HasRagConfig``'s
   widths over 12,582,912 random rows (f32, int8 replica, scales;
   merge_chunks 48): empty caches first, filled with that batch's full
   scan, then a batch repeating half of it (accepts and rejects), the
   rejected ids against ``chunked_flat_search`` up to proven near-ties,
   merge_chunks 0 equal to 48 at 1,572,864 rows; (b) dlrm-rm2, deepfm
   and autoint at full width: one train_batch (65,536) AdamW step,
   serve_p99 (512) and serve_bulk (262,144) forwards, retrieval_cand (1 x
   1,000,448, top-100, ids against a GEMV and a stable sort), and
   bert4rec's serve_p99 and its train_batch through
   ``make_train_step_accum`` in micro-batches of 256 sequences; (c) one
   DimeNet AdamW step at full width on full_graph_sm, molecule and
   minibatch_lg at their block dims (self-loops masked).  The parts run
   in the order a, d, c, b, as their host draws are ready.  Each shape
   reports its time, busy time, idle share, launches, peak memory and
   bound, and each train step the optimizer alone against its bytes
   bound.  The eight kernels' counts are set to 0 before phase 11 and
   must read 0 after;
12. the dry run and the roofline (``repro_torch.launch.dryrun``,
   ``launch/roofline.py``) and the multi-rank exact search, with the eight
   kernels' counts set to 0 before and read 0 after: (a) the four cells
   phases 10 and 11 measured (chatglm3-6b's 10b step, dlrm-rm2's
   train_batch, DimeNet's minibatch_lg, has-rag at 12,582,912 rows) run on
   ``meta`` with the variants that make their steps 10b's and 11's: the
   predicted peak (arguments + temp) within ``PEAK_TOL`` of the step's
   arguments and its ``max_memory_allocated`` above the baseline, the
   arguments, counted against model FLOPs, and the roofline's bound
   against the step time phases 10 and 11 measured (not measured again):
   that share must be at most 1; (b) ``distributed_flat_search`` at NCCL
   world 1 on the card and at gloo world 4 in CPU processes on its host
   (one card: NCCL takes one rank a card), ids against
   ``chunked_flat_search`` on the card up to proven near-ties; (c) the
   ``--all`` sweep in ``SWEEP_JOBS`` processes, started after (b) so that
   it runs beside (a) and no timed phase: all 41 cells OK with every key,
   each cell's bound at most the dry run's prediction for the port (the
   larger of its compute and traffic terms), their roofline written to
   ``chiprun_out/roofline.md`` beside ``dryrun.json``, and one decode
   cell on ``meta`` in this process;
13. the ``kernels`` JSON line (launches on phase 9's paths; the RAG and
   recsys kernels' on their own: ``decode_attention`` phases 6 and 6b),
   then the result line
   ``{"ok": true, "device": {...}}`` last.

Details of every phase are written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM non-tensor f32 / 32-bit (data sheet)
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
SCORE_TOL = 1e-5               # f32 sums of 768 products in another order
K = 10
ENTITIES = 100_000             # 500,000 passages
HAS_QUERIES = 1500             # through HasEngine
FULL_QUERIES = 400             # through FullRetrievalEngine
REPLAY_QUERIES = 300           # replayed with backend="torch"
PROFILE_STEPS = 100            # fresh queries of the profiled window
HYBRID = dict(dense="ann", dense_k=K, lexical_k=K, rrf_k=60.0,
              diversify_sim=0.98, tile_n=512,
              ann_kwargs=dict(n_clusters=1024, nprobe=32, compressed=True))
ANN_CAP = 977                  # ceil(500,000 / 1024 * 2)
BATCH = 32                     # max_spec_batch (sched_throughput.py:104)
TENANT_QUERIES = 400           # per tenant (sweep_tenants: 1600 // 4)
SHARE_BATCHES = 20             # micro-batches held to intra_batch_share
SHARE_TAU_MULT = 0.5           # the scheduler's DEFAULT_SHARE_TAU_MULT
PROFILE_BATCHES = 10           # fresh micro-batches of the batched window
ANN_BUCKETS = 4096             # ANNSEngine's default scope
POOL = 2 * K                   # fused pool: dense_k + lexical_k slots
RETRIEVAL_KERNELS = ("topk_search", "ivf_scan", "homology_score",
                     "ivf_scan_int8", "lexical_score", "fused_rerank")
DECODE_TOL = 2e-5              # f32 softmax sums in another order (rtol+atol)
# the hand-written kernels' names, for the profiler's device times
TOPK_KERNELS = ("topk_scan_kernel", "topk_block_merge_kernel")
DECODE_KERNELS = ("decode_attn_mma_kernel", "decode_attn_simt_kernel")
IVF_KERNELS = ("ivf_range_kernel",)
HOMOLOGY_KERNEL = "homology_kernel"
FUSED_KERNEL = "fused_topk_kernel"
LEXICAL_KERNEL = "lexical_kernel"
BAG_KERNEL = "bag_kernel"
IVF_BACK_TO_BACK = 200         # calls on one stream, then the tickets read 0
PROFILE_MARGIN_S = 0.02        # idle host time at each end of a profiled window
TAU = 0.2                      # HaS accept threshold (Algorithm 1 line 11)
TENANTS = 4                    # partitions of the tenant path (phase 7)
GROUPED_TOPK = "B=32,N=200000 grouped"        # phase-3 keys of the shapes
GROUPED_HOMOLOGY = "B=32,H=20000 grouped"     # the tenant path gives them
REVAL_BATCH = 16               # the scheduler's full_batch (re-validation)
REVAL_SHAPE = "B=16,H=5000 reval"
SHARE_ROWS = 256 + 32          # max_pending_leaders + max_spec_batch
SHARE_SHAPE = "288x288 sharing"
SCHED_KW = dict(max_spec_batch=BATCH, full_batch=REVAL_BATCH,
                full_max_wait_s=0.05)   # examples/async_serving.py's
SCHED_PROFILE = 10             # speculation dispatches profiled alone
CHAOS_QUERIES = 1200           # the reference's chaos benchmark stream
SHARDS = 4                     # ShardedMeshBackend(n_shards=4, n_workers=4)
ANN_INGEST = dict(n_clusters=1024, nprobe=32, residual_cap=1024)  # serve's
INGEST_NEW, INGEST_FLOOD = 2048, 4096   # new passages, then a flood near c0
INGEST_DOCS = 1 + INGEST_NEW + INGEST_FLOOD
# the bucket capacity of the index rebuilt over the grown corpus
REBUILT_CAP = int(np.ceil((5 * ENTITIES + INGEST_DOCS) / 1024 * 2.0))
INGEST_QUERIES = 64            # kernels against torch after each batch
AGENTIC_QUERIES = 900          # benchmarks/sched_agentic.py's complex queries
CLI_QUERIES = 400
CLI_BACKENDS = {"flat": [], "sharded": ["--retrieval-backend", "sharded"],
                "replica": ["--retrieval-backend", "replica"],
                "ann": ["--retrieval-backend", "ann"],
                "hybrid sharded": ["--retrieval-backend", "hybrid",
                                   "--hybrid-dense", "sharded"]}
CLI_INVALID = (["--engine", "has", "--agentic-frac", "0.3"],
               ["--engine", "sched", "--agentic-frac", "0.3", "--hops",
                "0"])
# full-scan doc hits of the 400 served queries in the CPU reference (numpy
# 2.0.2): the card must build the same world and stream and find them
REF_FULL_DOC_HITS = {"config1": 292, "quickstart": 249}
# Criteo Kaggle's 26 categorical vocabularies (src/repro/models/recsys.py:28)
CRITEO_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                 7046547, 18, 15, 286181, 105, 142572)
# (fields' vocabularies, embed dim) of the repo's Criteo tables
# (src/repro/configs/recsys_archs.py); rows padded to a multiple of 256
BAG_TABLES = {"deepfm": (CRITEO_VOCABS + (100_000,) * 13, 10),
              "dlrm-rm2": (CRITEO_VOCABS, 64)}
BAG_BATCH = 512                # the serve_p99 shape
BAG_PATH_BATCHES = 16          # fresh batches per table on the lookup path
RAG_REQUESTS, RAG_BATCH, RAG_PROMPT, RAG_GEN = 64, 8, 2048, 64
# kernel vs plain decode of one batch: logits agree within this (bf16
# logits, |logit| < 8: up to 8 ulps of 2^-5), and where the greedy tokens
# part, both runs' logits of the two tokens lie within it
LOGIT_TOL = 0.25
# phase 6b: the MoE generators at full width, depth cut to fit 80 GB
# (layers kept of 40 and 35; 263 and 954 GB of bf16 weights uncut)
MOE_ARCHS = {"dbrx-132b": 4, "arctic-480b": 2}
MOE_REQUESTS = 16              # two batches of RAG_BATCH
MOE_GROUPS = {"G=6 (dbrx-132b: 48/8)": 48, "G=7 (arctic-480b: 56/8)": 56}
# the bf16 MoE layer against a plain f32 loop over each token's routed
# experts: 4 bf16 ulps at |out| in [2, 4); the layer rounds h, the
# products and each add to bf16 (this script measured 0.0091 and 0.0092
# on an H100 80GB HBM3 at 700 W, |out| up to 1.6)
MOE_TOL = 0.0625
# kernel vs plain replay: where a token's routed experts differ, the
# swapped experts' f32 router logits lie within this in both runs (4x the
# largest router-logit difference between the runs on rows whose routing
# agreed: 0.031, dbrx-132b, 4 layers, H100 80GB HBM3 at 700 W)
ROUTER_TOL = 0.125
RAG_TWIN_REQUESTS = 200        # examples/rag_serving_torch.py's default
# phase 10: training
TRAIN_STEPS, TRAIN_RESUME = 200, 20   # lm100m through launch.train.main
TRAIN_MICRO, TRAIN_N_MICRO = 2, 4     # chatglm3-6b: 8 sequences a step
# of 28: the most whose peak stays under ~72 GB (60.1 GB at 12 layers,
# plus 3.26 GB a layer of f32 weights, grads and AdamW moments; H100 80GB
# HBM3, 700 W)
TRAIN_DENSE_LAYERS = 15
TRAIN_MOE_LAYERS = 2           # of 40: bf16 weights and grads
TRAIN_CHECK_LAYERS = 2         # 10b's checks, where remat=False fits
TRAIN_RUN = 3                  # steps of 10b and 10c
# lm100m, resumed or run twice: the same f32 losses up to the order of the
# card's adds (this script measured 0 difference on an H100 80GB HBM3 at
# 700 W)
RESUME_TOL = 1e-3
# remat "full" / "dots" against remat=False, bf16 compute: the same
# products recomputed; loss difference and max gradient error over the
# largest gradient (measured 0: bit-equal)
REMAT_TOL = 1e-2
# accumulation (4 x 2 sequences) against one 8-sequence step, f32: the
# loss, the norm and the first moment relative to the largest (measured
# 0, 6.4e-8 and 7.8e-6)
ACCUM_TOL = 1e-3
# bf16 against f32 compute on the same masters: the loss (ln 65024 = 11.1;
# measured 1.0e-4 apart)
BF16_LOSS_TOL = 0.05


# phase 11: the registry and the remaining model families
P11_STEPS = 3                  # launch.train.main steps of each arch (11a)
# the card against the CPU at the smoke configs (f32): forward, loss and
# every gradient leaf within this of the leaf's largest (sums in other
# orders; DimeNet's index_add adds with atomics, in another order each run)
SMOKE_TOL = 1e-4
# serve_bulk's batch, drawn once per field set; train_batch and serve_p99
# are its first 65,536 and 512 rows
RECSYS_BULK = 262144
BERT_MICRO = 256               # bert4rec sequences a micro-batch (5.5 GB of f32 logits)
GNN_RUN = ("full_graph_sm", "molecule", "minibatch_lg")
# has-rag's corpus rows, 3 x 2^22: the f32 rows, the int8 replica and the
# scales take 3,844 B a row, 48.4 GB (the paper's 49.2M rows need 189 GB)
HASRAG_ROWS = 12_582_912
HASRAG_CHUNKS = 48             # merge_chunks: 262,144 columns a chunk
HASRAG_SORT_ROWS = 48 << 15    # merge_chunks 0 (whole-row sort) vs 48 here
# where two top-k lists part, the two rows' f64 scores lie within this
# (relative): f32 sums of up to 768 products in other orders
NEAR_TIE_REL = 1e-5
PROFILE_TRIES = 3              # traces of a short call; the fullest is kept

# phase 12: the dry run, the roofline and the multi-rank exact search
# 12a: the cells whose steps phases 10 and 11 measured, with the dry run's
# variants that make its step theirs
P12_CELLS = {
    "chatglm3-6b": ("train_4k", dict(
        n_layers=TRAIN_DENSE_LAYERS, global_batch=TRAIN_MICRO * TRAIN_N_MICRO,
        n_micro=TRAIN_N_MICRO)),
    "dlrm-rm2": ("train_batch", {}),
    "dimenet": ("minibatch_lg", {}),
    "has-rag": ("retrieve_batch", dict(corpus_size=HASRAG_ROWS)),
}
PEAK_TOL = 0.10                # the dry run's peak and arguments, relative
DIST_ROWS = 262_144            # 12b's corpus (d=768): 65,536 rows a gloo rank
DIST_QUERIES = 64
DIST_WORLD = 4                 # gloo ranks on the card's host
DIST_DEADLINE_S = 120
SWEEP_CELLS = 41               # the registry's (arch x shape) cells
SWEEP_JOBS = 6                 # the sweep's processes on the card's host
SWEEP_WAIT_S = 420             # 12c's longest wait for the sweep to end


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Timing and comparison helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of a call, CUDA events, L2 flushed before each."""

    def __init__(self, dev):
        self.flush = torch.empty(32 * 1024 * 1024, device=dev)   # 128 MB

    def __call__(self, fn, reps=30, warm=3) -> float:
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def device_times(fn, reps: int, warm: bool = True,
                 counts: dict | None = None) -> dict[str, float]:
    """Device time (us) per call of every kernel ``fn`` runs, by name, from
    ``torch.profiler`` (CUPTI).  Empty if the profiler saw no device
    activity.  ``counts``, if given, receives the launches per call."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # Kineto drops device records that fall outside its capture window
        # on the host clock; a margin on each side keeps a skew between the
        # two clocks from cutting off the first or last calls.
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / reps
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count / reps
    return out


def host_device_split(fn, calls: int = 200, runs: int = 5) -> dict:
    """Where a call's time goes: host time per call (``perf_counter`` over
    ``calls`` calls with no synchronize, median of ``runs`` runs) and the
    device time and launches per call of every kernel it runs
    (profiler)."""
    fn()
    per = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    counts = {}
    times = device_times(fn, 20, counts=counts)
    return {"host_us": statistics.median(per), "host_us_runs": per,
            "device_us": sum(times.values()),
            "launches": sum(counts.values()),
            "kernels_us": {kernel_name(k): v for k, v in times.items()}}


def own_kernels(times: dict[str, float], names) -> dict[str, float]:
    """Device time (us) of the kernels whose name contains one of ``names``
    (the hand-written ones; not torch's allocations or fills), by short
    name."""
    out = {}
    for k, t in times.items():
        for n in names:
            if n in k:
                out[n] = out.get(n, 0.0) + t
    return out


def own_kernel_us(times: dict[str, float], names) -> float:
    return sum(own_kernels(times, names).values())


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel symbol: the last
    length-prefixed identifier that ends in ``_kernel``."""
    found = None
    for m in re.finditer(r"(?=(\d+))", mangled):    # every digit suffix
        n, at = int(m.group(1)), m.start() + len(m.group(1))
        name = mangled[at:at + n]
        if name.endswith("_kernel") and name.replace("_", "").isalnum():
            found = (name, mangled[at + n:])
    if found is None:
        return mangled
    name, rest = found
    args = []
    if rest.startswith("I"):
        args = ["".join(a) for a in re.findall(
            r"Li(\d+)E|(bfloat16)|I(f)(?=L)|LN\w*?E(\d+)E",
            rest[:rest.find("EE") + 1])]
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(text: str) -> dict[str, dict]:
    """Registers, static shared memory and spills per kernel from nvcc's
    ``-Xptxas -v`` output, keyed by a short form of the kernel's name."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = out.setdefault(kernel_name(m.group(1)), {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fn["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            fn["smem"] = int(m.group(1))
    return out


def float_err(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Max abs difference; -inf must meet -inf."""
    ia, ib = torch.isneginf(a), torch.isneginf(b)
    if not torch.equal(ia, ib):
        raise AssertionError(f"{what}: -inf positions differ")
    if not (torch.isfinite(a) | ia).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    d = torch.where(ia, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def compare_topk(what, kv, ki, pv, pi, score_of) -> tuple[float, int]:
    """Kernel (kv, ki) vs plain (pv, pi): scores within SCORE_TOL, ids equal
    except swaps between near-tied candidates: where the ids differ, the
    kernel's id must be a real one, appear once in its row, and score
    (``score_of(row, id)``, recomputed from the inputs) within SCORE_TOL of
    the plain score at that position.  Returns (max_abs_err, swaps)."""
    err = float_err(kv, pv, what)
    if err > SCORE_TOL:
        raise AssertionError(f"{what}: max score error {err}")
    swaps = 0
    ki_c, pv_c, diff = ki.cpu(), pv.cpu(), (ki != pi).cpu()
    for row, j in diff.nonzero().tolist():
        kid = int(ki_c[row, j])
        if kid < 0 or int((ki_c[row] == kid).sum()) != 1 or \
                abs(score_of(row, kid) - float(pv_c[row, j])) > SCORE_TOL:
            raise AssertionError(
                f"{what}: id {kid} vs {int(pi[row, j])} at [{row},{j}] is "
                f"not a near-tie")
        swaps += 1
    return err, swaps


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def ivf_check(rec, name, q, probe, vecs, ids, k, scales=None, bias=None):
    """ivf_scan against ivf_scan_plain in either mode (int8 when ``scales``
    and ``bias`` are given).  The kernel clamps an out-of-range probe; the
    plain version is given the clamped probe.  Returns the kernel's ids."""
    from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain

    n_b, cap = ids.shape
    kv, ki = ivf_scan(q, probe, vecs, ids, k, scales, bias)
    probe = probe.clamp(0, n_b - 1)
    pv, pi = ivf_scan_plain(q, probe, vecs, ids, k, scales, bias)
    h = q.shape[1] // 2
    flat_ids = ids.view(-1)

    def score_of(r, gid):               # global ids are unique here
        slot = int((flat_ids == gid).nonzero()[0, 0])
        c, s_ = divmod(slot, cap)
        at = (probe[r] == c).nonzero()
        if not len(at):
            return -float("inf")        # not in a probed bucket
        v = vecs[c, s_].float()
        if scales is None:
            return float(q[r] @ v)
        return float((q[r, :h] @ v[:h]) * scales[c, s_, 0]
                     + (q[r, h:] @ v[h:]) * scales[c, s_, 1]
                     + bias[r, int(at[0, 0])])

    err, sw = compare_topk(f"{rec['name']}/{name}", kv, ki, pv, pi, score_of)
    rec["cases"][name] = {"max_abs_err": err, "swaps": sw}
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["swaps"] += sw
    return ki


def one_launch_us(what, call, symbol, tries: int = 3) -> float:
    """Device time (us) of one call, from the profiler, which must see one
    launch per call of the kernel ``symbol`` and nothing else: the
    reduction runs in the same launch, and no output or scratch is
    cleared.  A trace that shows another kernel, or more than one launch a
    call, fails at once.  CUPTI may drop a few kernel records from a
    window (seen on the H100: 2 of 20), and a trace with fewer records
    than calls would also understate the time, so such a trace is taken
    again, up to ``tries`` times in all."""
    for _ in range(tries):
        counts = {}
        times = device_times(call, 20, counts=counts)
        if set(counts) != {k for k in counts if symbol in k} or \
                sum(counts.values()) > 1:
            raise AssertionError(f"{what}: launches per call {counts}")
        if sum(counts.values()) == 1:
            return own_kernel_us(times, (symbol,))
        log(f"{what}: the profiler saw {counts} launches per call; "
            "tracing again")
    raise AssertionError(f"{what}: launches per call {counts} in each of "
                         f"{tries} traces")


def ivf_edge_cases(dev, g, rec, scaled: bool):
    """ivf_scan's one-launch merge against the plain version in one mode:
    B = 1, 7, 64, 65; k = 1, 10, MAX_K; P = 1, 64, 512; a pool smaller than
    k; every probed slot a pad; out-of-range probes; equal vectors in two
    probed buckets (the tie goes to the earlier probe); d = 770 (the
    scalar loads) beside d = 768; back-to-back calls on one stream (the
    tickets read zero after) and calls on two streams."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.kernels.topk_search import MAX_K

    def world(n_b, cap, d):
        ids = torch.randperm(n_b * cap, device=dev, generator=g) \
            .int().reshape(n_b, cap)
        ids[torch.rand(n_b, cap, device=dev, generator=g) < 0.3] = -1
        if not scaled:
            v = torch.randn(n_b, cap, d, device=dev, generator=g)
            v = v / v.norm(dim=-1, keepdim=True)
            return v, ids, None
        v = torch.randint(-127, 128, (n_b, cap, d), dtype=torch.int8,
                          device=dev, generator=g)
        sc = torch.rand(n_b, cap, 2, device=dev, generator=g) * 1e-3 + 1e-4
        return v, ids, sc

    def queries(b, d):
        x = torch.randn(b, d, device=dev, generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    def probes(b, p, n_b):
        return torch.stack([torch.randperm(n_b, device=dev, generator=g)[:p]
                            for _ in range(b)]).int()

    def bias(b, p):
        return torch.randn(b, p, device=dev, generator=g) * 0.3 \
            if scaled else None

    def case(name, q, probe, vecs, ids, sc, k=K, bs=None):
        bs = bias(*probe.shape) if bs is None and scaled else bs
        return ivf_check(rec, name, q, probe, vecs, ids, k, sc, bs)

    n_b, cap, d = 1024, 61, 768
    vecs, ids, sc = world(n_b, cap, d)
    for b in (1, 7, 64, 65):
        case(f"edge B={b},P=64,cap={cap}", queries(b, d), probes(b, 64, n_b),
             vecs, ids, sc)
    for k in (1, MAX_K):
        case(f"edge B=7,P=64,k={k}", queries(7, d), probes(7, 64, n_b), vecs,
             ids, sc, k=k)
    for p in (1, 512):
        case(f"edge B=7,P={p}", queries(7, d), probes(7, p, n_b), vecs, ids,
             sc)
    case("edge pool < k (P=3, cap 3), k=10", queries(3, d),
         probes(3, 3, n_b), vecs[:, :3].contiguous(),
         ids[:, :3].contiguous(), None if sc is None else
         sc[:, :3].contiguous())
    pads = ids.clone()
    pads[:40] = -1
    got = case("edge every probed slot a pad", queries(4, d),
               probes(4, 40, 40), vecs, pads, sc)
    if not (got == -1).all():
        raise AssertionError(f"{rec['name']}: an all-pad pool gave ids")
    oob = probes(5, 64, n_b - 2) + 1           # buckets 0 and n_b-1 free
    oob[:, 3], oob[:, 9] = n_b + 7, -3         # clamped to n_b-1 and 0
    case("edge out-of-range probes (clamped)", queries(5, d), oob, vecs,
         ids, sc)
    # equal vectors in two probed buckets: the earlier probe wins the tie
    tv, tids = vecs.clone(), ids.clone()
    pr = probes(2, 16, n_b)
    early, late = pr[0, 2], pr[0, 11]
    tv[late, 7] = tv[early, 30]
    tids[early, 30], tids[late, 7] = 10 ** 8, 10 ** 8 + 1
    tsc = None
    if scaled:                                 # the largest scales: top 2
        tsc = sc.clone()
        tsc[late, 7] = tsc[early, 30] = 1.1e-3
    q = tv[early, 30].float()[None].repeat(2, 1)
    q = q / q.norm(dim=-1, keepdim=True)
    bs = bias(2, 16)
    if scaled:
        bs[:, :] = 0.5                         # the same bias on every probe
    got = case("edge equal vectors in two probes", q, pr, tv, tids, tsc,
               bs=bs)
    if got[0, :2].tolist() != [10 ** 8, 10 ** 8 + 1]:
        raise AssertionError(f"{rec['name']}: the tie did not go to the "
                             f"earlier probe: {got[0, :2].tolist()}")
    del tv, tids, tsc
    sv, sids, ssc = world(64, 37, 770)
    case("edge d=770 (scalar loads), B=7,P=16", queries(7, 770),
         probes(7, 16, 64), sv, sids, ssc)
    # back to back on one stream, then the tickets
    q, pr = queries(7, d), probes(7, 64, n_b)
    bs = bias(7, 64)
    first = ivf_scan(q, pr, vecs, ids, K, sc, bs)
    for _ in range(IVF_BACK_TO_BACK - 1):
        last = ivf_scan(q, pr, vecs, ids, K, sc, bs)
    torch.cuda.synchronize()
    if not (torch.equal(first[0], last[0]) and torch.equal(first[1],
                                                           last[1])):
        raise AssertionError(f"{rec['name']}: back-to-back calls differ")
    for (name, _, _), (buf, n_tickets, _) in _build.scratch_cache.items():
        if name == "ivf_scan" and buf[:n_tickets].view(torch.int32).any():
            raise AssertionError(f"{rec['name']}: tickets not reset")
    rec["cases"]["edge back-to-back"] = {"calls": IVF_BACK_TO_BACK,
                                         "tickets_zero": True}
    # two streams at once, each against the plain version
    args = [(queries(b, d), probes(b, 64, n_b), bias(b, 64))
            for b in (3, 65)]
    streams = [torch.cuda.Stream() for _ in args]
    outs = []
    for st, (q, pr, bs) in zip(streams, args):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(ivf_scan(q, pr, vecs, ids, K, sc, bs))
    torch.cuda.synchronize()
    for i, ((q, pr, bs), (kv, ki)) in enumerate(zip(args, outs)):
        want = ivf_check(rec, f"edge stream {i}", q, pr, vecs, ids, K, sc,
                         bs)
        if not torch.equal(want, ki):
            raise AssertionError(f"{rec['name']}: stream {i} differs")


def check_kernels(dev, timer) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import (ivf_scan, ivf_scan_plain,
                                              plan_ranges)
    from repro_torch.kernels.topk_search import (topk_search,
                                                 topk_search_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    d = 768
    res = {}

    def unit(*shape):
        x = torch.randn(*shape, d, device=dev, generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    # -- topk_search: the cache channel over the doc ring ----------------
    rec = res["topk_search"] = {"cases": {}, "max_abs_err": 0.0, "swaps": 0}
    ring = unit(50_000)
    valid = torch.rand(50_000, device=dev, generator=g) < 0.9

    def topk_case(name, q, corpus, valid_, k=K, **kw):
        kv, ki = topk_search(q, corpus, k, valid_, **kw)
        pv, pi = topk_search_plain(q, corpus, k, valid_, **kw)
        err, sw = compare_topk(f"topk_search/{name}", kv, ki, pv, pi,
                               lambda r, i: float(q[r] @ corpus[i]))
        rec["cases"][name] = {"max_abs_err": err, "swaps": sw}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["swaps"] += sw

    for b in (1, 7, 64, 65):                      # 7, 65: ragged query tiles
        topk_case(f"B={b},N=50000", unit(b), ring, valid)
    for k in (1, 100):
        topk_case(f"B=1,N=50000,k={k}", unit(1), ring, valid, k=k)
        topk_case(f"B=64,N=50000,k={k}", unit(64), ring, valid, k=k)
    topk_case("tail tile N=300", unit(3), ring[:300].contiguous(),
              valid[:300].contiguous())
    topk_case("empty ring", unit(2), ring[:1000].contiguous(),
              torch.zeros(1000, dtype=torch.bool, device=dev))
    topk_case("4 valid rows < k", unit(2), ring[:1000].contiguous(),
              torch.arange(1000, device=dev) % 250 == 0)
    topk_case("groups", unit(8), ring[:5000].contiguous(),
              valid[:5000].contiguous(),
              row_group=(torch.arange(5000, device=dev) % 3).int(),
              q_group=(torch.arange(8, device=dev) % 3).int())
    q1, q64 = unit(1), unit(64)
    # the batched tenant path's cache channel: 4 tenants' rings flattened
    # to T*Dc rows, micro-batches of 32
    tring = unit(TENANTS * 50_000)
    tvalid = torch.rand(tring.shape[0], device=dev, generator=g) < 0.9
    trg = torch.arange(tring.shape[0], device=dev).div(
        50_000, rounding_mode="floor").int()
    q32, tqg = unit(32), (torch.arange(32, device=dev) % TENANTS).int()
    topk_case(GROUPED_TOPK, q32, tring, tvalid, row_group=trg, q_group=tqg)
    topk_case("B=32,N=50000", q32, ring, valid)    # the scheduler's, T=1
    n_bytes = q32.numel() * 4 + tring.numel() * 4 + tvalid.numel() \
        + trg.numel() * 4 + tqg.numel() * 4 + 32 * K * 8
    bms, by = bound(n_bytes, 2 * 32 * tring.numel())
    grp = dict(row_group=trg, q_group=tqg)
    own = own_kernels(device_times(
        lambda: topk_search(q32, tring, K, tvalid, **grp), 20), TOPK_KERNELS)
    rec[GROUPED_TOPK] = {
        "ms": timer(lambda: topk_search(q32, tring, K, tvalid, **grp)),
        "plain_ms": timer(lambda: topk_search_plain(q32, tring, K, tvalid,
                                                    **grp)),
        "library_ms": timer(lambda: torch.topk(q32 @ tring.T, K)),
        "bound_ms": bms, "bound_by": by,
        "kernel_device_us": sum(own.values()),
        "kernel_device_us_by_name": own}
    del tring, tvalid, trg
    for b, q in ((1, q1), (32, q32), (64, q64)):
        n_bytes = q.numel() * 4 + ring.numel() * 4 + valid.numel() \
            + b * K * 8
        bms, by = bound(n_bytes, 2 * b * ring.numel())
        own = own_kernels(device_times(
            lambda: topk_search(q, ring, K, valid), 20), TOPK_KERNELS)
        rec[f"B={b}"] = {
            "ms": timer(lambda: topk_search(q, ring, K, valid)),
            "plain_ms": timer(lambda: topk_search_plain(q, ring, K, valid)),
            "library_ms": timer(lambda: torch.topk(q @ ring.T, K)),
            "bound_ms": bms, "bound_by": by,
            "kernel_device_us": sum(own.values()),
            "kernel_device_us_by_name": own}
    del ring

    # -- ivf_scan: the fuzzy channel's probed-bucket scan ------------------
    rec = res["ivf_scan"] = {"name": "ivf_scan", "cases": {},
                             "max_abs_err": 0.0, "swaps": 0}
    n_b, cap = 8192, 123
    bvecs = unit(n_b, cap)
    bids = torch.randperm(n_b * cap, device=dev, generator=g) \
        .int().reshape(n_b, cap)
    pad = torch.rand(n_b, cap, device=dev, generator=g) < 0.5
    bids[pad] = -1                               # ~half the slots are pads
    bvecs[pad] = 0.0

    def probes(b, p):
        return torch.stack([torch.randperm(n_b, device=dev, generator=g)[:p]
                            for _ in range(b)]).int()

    pr1, pr32, pr64 = probes(1, 64), probes(32, 64), probes(64, 64)
    ivf_check(rec, "B=1,P=64", q1, pr1, bvecs, bids, K)
    ivf_check(rec, "B=32,P=64", q32, pr32, bvecs, bids, K)
    ivf_check(rec, "B=64,P=64", q64, pr64, bvecs, bids, K)
    ivf_check(rec, "pool < k (P=1, cap 4)", unit(3), probes(3, 1),
              bvecs[:, :4].contiguous(), bids[:, :4].contiguous(), K)
    for b, q, pr in ((1, q1, pr1), (32, q32, pr32), (64, q64, pr64)):
        # the probed buckets' ids, and the vectors of their valid slots
        uniq = torch.unique(pr.long())
        valid = int((bids[uniq] >= 0).sum())
        n_bytes = q.numel() * 4 + pr.numel() * 4 + uniq.numel() * cap * 4 \
            + valid * d * 4 + b * K * 8
        bms, by = bound(n_bytes, 2 * b * pr.shape[1] * cap * d)

        def library(q=q, pr=pr):
            s = torch.bmm(bvecs[pr.long()].reshape(q.shape[0], -1, d),
                          q[:, :, None])[..., 0]
            return torch.topk(s, K)

        rec[f"B={b}"] = {
            "ms": timer(lambda: ivf_scan(q, pr, bvecs, bids, K)),
            "plain_ms": timer(lambda: ivf_scan_plain(q, pr, bvecs, bids, K)),
            "library_ms": timer(library),
            "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "ivf_scan", lambda: ivf_scan(q, pr, bvecs, bids, K),
                IVF_KERNELS[0]),
            "ranges": plan_ranges(b, pr.shape[1], cap, K,
                                  _build.sm_count(dev))}
    del bvecs, bids
    ivf_edge_cases(dev, g, rec, scaled=False)

    # -- homology_score: validation against the query cache ---------------
    res["homology_score"] = check_homology(dev, g, timer)
    return res


def check_homology(dev, g, timer) -> dict:
    """homology_score and homology_validate (scores, best, slot in one
    launch) against their plain versions; the split validation sequence
    (scores, then first_argmax and the gather in launches of their own)
    timed beside the new one."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.homology_score import (homology_score,
                                                    homology_score_plain,
                                                    homology_validate,
                                                    homology_validate_plain)
    from repro_torch.utils import first_argmax

    rec = {"cases": {}, "max_abs_err": 0.0, "slot_near_ties": 0}
    h = 5000

    def table(k):
        return torch.randint(-1, 2000, (h, k), device=dev, generator=g,
                             dtype=torch.int32)

    def drafts(b, cache_):
        x = torch.randint(-1, 2000, (b, cache_.shape[1]), device=dev,
                          generator=g, dtype=torch.int32)
        n = b // 2 + 1
        x[:n, :3] = cache_[torch.randint(0, h, (n,), device=dev,
                                         generator=g), :3]   # real overlaps
        return x

    cache = table(K)
    cvalid = torch.rand(h, device=dev, generator=g) < 0.8

    def hom_case(name, draft, cache_, valid_, exact=True, **kw):
        ks = homology_score(draft, cache_, valid_, **kw)
        kv = homology_validate(draft, cache_, valid_, **kw)
        ps, pb, pt = homology_validate_plain(draft, cache_, valid_, **kw)
        err = max(float_err(x, ps, f"homology_score/{name}")
                  for x in (ks, kv[0]))
        ties = 0
        if exact:
            if not (torch.equal(ks, ps) and torch.equal(kv[0], ps)
                    and torch.equal(kv[1], pb) and torch.equal(kv[2], pt)):
                raise AssertionError(f"homology_score/{name}: scores, best "
                                     f"or slot not bit-equal")
        else:
            at = torch.gather(ps, 1, kv[2].long()[:, None])[:, 0]
            if err > 1e-6 or float((kv[1] - pb).abs().max()) > 1e-6 or \
                    float((at - pb).abs().max()) > 1e-6:
                raise AssertionError(f"homology_score/{name}: error {err}")
            ties = int((kv[2] != pt).sum())
        rec["cases"][name] = {"max_abs_err": err, "slot_near_ties": ties}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["slot_near_ties"] += ties
        return kv

    d1, d64 = drafts(1, cache), drafts(64, cache)
    hom_case("B=1,H=5000", d1, cache, cvalid)
    hom_case("B=64,H=5000", d64, cache, cvalid)
    hom_case("B=200,H=5000", drafts(200, cache), cache, cvalid)
    for k in (1, 32, 7):                  # the other templated widths and
        ck = table(k)                     # the generic route
        hom_case(f"B=64,k={k}", drafts(64, ck), ck, cvalid)
    none = torch.zeros(h, dtype=torch.bool, device=dev)
    got = hom_case("empty cache", d64, cache, none)
    if got[1].any() or got[2].any():
        raise AssertionError("homology_validate: an empty cache gave a row")
    w = torch.rand(64, K, device=dev, generator=g)
    hom_case("draft_weights (normalised)", d64, cache, cvalid, exact=False,
             draft_weights=w / w.sum(1, keepdim=True))
    hom_case("draft_weights (multiples of 1/64)", d64, cache, cvalid,
             draft_weights=torch.randint(0, 9, (64, K), device=dev,
                                         generator=g).float() / 64)
    hom_case("groups", d64, cache, cvalid,
             row_group=(torch.arange(h, device=dev) % 4).int(),
             q_group=(torch.arange(64, device=dev) % 4).int())
    # equal best scores in rows of other CTAs: the lowest row wins
    tc = cache.clone()
    td = torch.arange(3 * K, device=dev, dtype=torch.int32).reshape(3, K) \
        + 10 ** 6
    for row, rows in enumerate(((4999, 130, 3001), (128, 127), (4000,))):
        tc[list(rows), :4] = td[row, :4]
    got = hom_case("ties across CTAs", td, tc, torch.ones_like(cvalid))
    if got[2].tolist() != [130, 127, 4000]:
        raise AssertionError(f"homology_validate: ties went to "
                             f"{got[2].tolist()}")
    # back to back on one stream, then the tickets; two streams at once
    first = homology_validate(d64, cache, cvalid)
    for _ in range(IVF_BACK_TO_BACK - 1):
        last = homology_validate(d64, cache, cvalid)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, last)):
        raise AssertionError("homology_validate: back-to-back calls differ")
    for (name, _, _), (buf, n_tickets, _) in _build.scratch_cache.items():
        if name == "homology_score" and \
                buf[:n_tickets].view(torch.int32).any():
            raise AssertionError("homology_validate: tickets not reset")
    rec["cases"]["back-to-back"] = {"calls": IVF_BACK_TO_BACK,
                                    "tickets_zero": True}
    args = [drafts(b, cache) for b in (3, 65)]
    streams = [torch.cuda.Stream() for _ in args]
    outs = []
    for st, dr in zip(streams, args):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(homology_validate(dr, cache, cvalid))
    torch.cuda.synchronize()
    for i, (dr, got) in enumerate(zip(args, outs)):
        want = homology_validate_plain(dr, cache, cvalid)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"homology_validate: stream {i} differs")

    # the batched tenant path's validation: 4 tenants' query caches
    # flattened to T*H rows, micro-batches of 32; drafts of a tenant whose
    # rows all score 0 take row 0 (another tenant's), as the reference's
    # argmax over the flat scores does
    th = TENANTS * h
    tcache = torch.randint(-1, 2000, (th, K), device=dev, generator=g,
                           dtype=torch.int32)
    tcvalid = torch.rand(th, device=dev, generator=g) < 0.8
    trg = torch.arange(th, device=dev).div(h, rounding_mode="floor").int()
    tqg = (torch.arange(32, device=dev) % TENANTS).int()
    tcvalid[trg == 3] = False                    # tenant 3: an empty cache
    tdr = torch.randint(-1, 2000, (32, K), device=dev, generator=g,
                        dtype=torch.int32)
    pick = tqg.long() * h + torch.randint(0, h, (32,), device=dev,
                                          generator=g)
    tdr[::2, :3] = tcache[pick[::2], :3]          # real overlaps, own tenant
    grp = dict(row_group=trg, q_group=tqg)
    got = hom_case(GROUPED_HOMOLOGY, tdr, tcache, tcvalid, **grp)
    if (got[2][tqg == 3] != 0).any():
        raise AssertionError("homology_validate: an empty tenant's drafts "
                             "did not take row 0")
    n_bytes = tdr.numel() * 4 + tcache.numel() * 4 + th + th * 4 + 32 * 4 \
        + 32 * th * 4 + 32 * 8
    bms, by = bound(n_bytes, 32 * th * K * K)
    rec[GROUPED_HOMOLOGY] = {
        "ms": timer(lambda: homology_validate(tdr, tcache, tcvalid, **grp)),
        "plain_ms": timer(lambda: homology_validate_plain(tdr, tcache,
                                                          tcvalid, **grp)),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        "kernel_device_us": one_launch_us(
            "homology_validate grouped",
            lambda: homology_validate(tdr, tcache, tcvalid, **grp),
            HOMOLOGY_KERNEL)}

    # the scheduler's late re-validation: B=16 queued drafts (rows past
    # the batch padded with -1) against the query cache
    d16 = drafts(REVAL_BATCH, cache)
    d16[REVAL_BATCH // 2 + 3:] = -1
    hom_case(REVAL_SHAPE, d16, cache, cvalid)
    n_bytes = d16.numel() * 4 + cache.numel() * 4 + h + REVAL_BATCH * h * 4 \
        + REVAL_BATCH * 8
    bms, by = bound(n_bytes, REVAL_BATCH * h * K * K)
    rec[REVAL_SHAPE] = {
        "ms": timer(lambda: homology_validate(d16, cache, cvalid)),
        "plain_ms": timer(lambda: homology_validate_plain(d16, cache,
                                                          cvalid)),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        "kernel_device_us": one_launch_us(
            "homology_validate B=16",
            lambda: homology_validate(d16, cache, cvalid), HOMOLOGY_KERNEL)}
    # the scheduler's sharing election: the registry's 256 pending leaders
    # and a speculation batch of 32 scored against each other (rows neither
    # rejected nor pending masked, as intra_batch_share passes them)
    n_sh = SHARE_ROWS
    vals = torch.full((n_sh, K), -1, device=dev, dtype=torch.int32)
    live = torch.rand(n_sh, device=dev, generator=g) < 0.4
    vals[live] = drafts(int(live.sum()), cache)
    hom_case(SHARE_SHAPE, vals, vals, live)
    n_bytes = 2 * vals.numel() * 4 + n_sh + n_sh * n_sh * 4
    bms, by = bound(n_bytes, n_sh * n_sh * K * K)
    rec[SHARE_SHAPE] = {
        "ms": timer(lambda: homology_score(vals, vals, live)),
        "plain_ms": timer(lambda: homology_score_plain(vals, vals, live)),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        "kernel_device_us": one_launch_us(
            "homology_score sharing", lambda: homology_score(vals, vals,
                                                             live),
            HOMOLOGY_KERNEL)}

    tau = torch.tensor(TAU, dtype=torch.float32)

    def split_sequence(dr):               # scores, then the argmax
        scores = homology_score(dr, cache, cvalid)
        slot = first_argmax(scores)
        return torch.gather(scores, 1, slot[:, None])[:, 0] > tau

    def new_sequence(dr):
        return homology_validate(dr, cache, cvalid)[1] > tau

    for b, dr in ((1, d1), (64, d64)):
        n_bytes = dr.numel() * 4 + cache.numel() * 4 + h + b * h * 4 + b * 8
        bms, by = bound(n_bytes, b * h * K * K)
        seq = {}
        for name, fn in (("split", split_sequence),
                         ("one launch", new_sequence)):
            counts = {}
            times = device_times(lambda: fn(dr), 20, counts=counts)
            seq[name] = {"ms": timer(lambda: fn(dr)),
                         "device_us": sum(times.values()),
                         "launches": sum(counts.values())}
        rec[f"B={b}"] = {
            "ms": timer(lambda: homology_validate(dr, cache, cvalid)),
            "plain_ms": timer(lambda: homology_validate_plain(dr, cache,
                                                              cvalid)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "homology_validate",
                lambda: homology_validate(dr, cache, cvalid),
                HOMOLOGY_KERNEL),
            "scores_only_ms": timer(lambda: homology_score(dr, cache,
                                                           cvalid)),
            "scores_only_device_us": one_launch_us(
                "homology_score", lambda: homology_score(dr, cache, cvalid),
                HOMOLOGY_KERNEL),
            "validation_to_accept": seq}
    return rec


def check_hybrid_kernels(dev, timer) -> dict:
    """Phase 3 for the hybrid cloud stage's kernels: int8 ivf_scan,
    lexical_score and fused_rerank."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import (ivf_scan, ivf_scan_plain,
                                              plan_ranges)
    from repro_torch.kernels.lexical_score import MAX_K as MAX_LEX_K
    from repro_torch.kernels.lexical_score import (lexical_score,
                                                   lexical_score_plain,
                                                   plan_chunks, plan_grid)
    from repro_torch.retrieval.lexical import build_doc_terms, query_terms

    g = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    d, h = 768, 384
    res = {}

    def unit(*shape):
        x = torch.randn(*shape, d, device=dev, generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    # -- ivf_scan, int8 residual codes: the cloud stage's dense channel -----
    rec = res["ivf_scan_int8"] = {"name": "ivf_scan_int8", "cases": {},
                                  "max_abs_err": 0.0, "swaps": 0}
    n_b, cap, p_ = 1024, ANN_CAP, 32
    codes = torch.randint(-127, 128, (n_b, cap, d), dtype=torch.int8,
                          device=dev, generator=g)
    scales = torch.rand(n_b, cap, 2, device=dev, generator=g) * 1e-3 + 1e-4
    bids = torch.randperm(n_b * cap, device=dev, generator=g) \
        .int().reshape(n_b, cap)
    bids[torch.rand(n_b, cap, device=dev, generator=g) < 0.5] = -1
    bids[3] = -1                                   # an all-pad bucket
    codes[4] = 0                                   # all-zero residuals:
    scales[4] = 1e-12                              # the scale floor

    def probes(b, p):
        return torch.stack([torch.randperm(n_b, device=dev, generator=g)[:p]
                            for _ in range(b)]).int()

    q1, q64 = unit(1), unit(64)
    pr1, pr64 = probes(1, p_), probes(64, p_)
    b1, b64 = (torch.randn(b, p_, device=dev, generator=g) * 0.3
               for b in (1, 64))
    ivf_check(rec, "B=1,P=32", q1, pr1, codes, bids, K, scales, b1)
    ivf_check(rec, "B=64,P=32", q64, pr64, codes, bids, K, scales, b64)
    pr_edge = pr64[:4].clone()
    pr_edge[:, 0], pr_edge[:, 1] = 3, 4            # all-pad, zero residual
    ivf_check(rec, "all-pad bucket + zero residual", q64[:4], pr_edge,
              codes, bids, K, scales, b64[:4].contiguous())
    ivf_check(rec, "pool < k (P=1, cap 4)", unit(3), probes(3, 1),
              codes[:, :4].contiguous(), bids[:, :4].contiguous(), K,
              scales[:, :4].contiguous(), b64[:3, :1].contiguous())
    for b, q, pr, bias in ((1, q1, pr1, b1), (64, q64, pr64, b64)):
        # the probed buckets' ids, and the codes and scales of their valid
        # slots
        uniq = torch.unique(pr.long())
        valid = int((bids[uniq] >= 0).sum())
        n_bytes = q.numel() * 4 + pr.numel() * 8 + uniq.numel() * cap * 4 \
            + valid * (d + 8) + b * K * 8
        bms, by = bound(n_bytes, 2 * b * p_ * cap * d)

        def library(q=q, pr=pr):
            s_ = torch.bmm(codes[pr.long()].float().reshape(q.shape[0], -1,
                                                            d),
                           q[:, :, None])[..., 0]
            return torch.topk(s_, K)

        rec[f"B={b}"] = {
            "ms": timer(lambda: ivf_scan(q, pr, codes, bids, K, scales,
                                         bias)),
            "plain_ms": timer(lambda: ivf_scan_plain(q, pr, codes, bids, K,
                                                     scales, bias), reps=10),
            "library_ms": timer(library, reps=10),
            "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "ivf_scan (int8)",
                lambda: ivf_scan(q, pr, codes, bids, K, scales, bias),
                IVF_KERNELS[0]),
            "ranges": plan_ranges(b, p_, cap, K, _build.sm_count(dev))}
    del codes, scales, bids
    torch.cuda.empty_cache()
    ivf_edge_cases(dev, g, rec, scaled=True)

    # -- lexical_score: the cloud stage's lexical channel -------------------
    rec = res["lexical_score"] = {"cases": {}, "max_abs_err": 0.0}
    n_ent = 100_000                               # 500,000 postings rows
    doc_entity = np.repeat(np.arange(n_ent), 5)
    attr_mask = np.zeros((5 * n_ent, 12), bool)
    for j in range(4):
        attr_mask[np.arange(5 * n_ent), rng.integers(0, 12, 5 * n_ent)] = True
    dt_np, dw_np = build_doc_terms(doc_entity, attr_mask, width=5)
    dt = torch.as_tensor(dt_np, device=dev)
    dw = torch.as_tensor(dw_np, device=dev)

    def lex_queries(b):
        qs = [query_terms(int(e), int(a)) for e, a in
              zip(rng.integers(0, n_ent, b), rng.integers(0, 12, b))]
        return (torch.as_tensor(np.stack([t for t, _ in qs]), device=dev),
                torch.as_tensor(np.stack([w for _, w in qs]), device=dev))

    def lex_case(name, qt, qw, dt_, dw_, tile_n=512, k=K):
        n0 = lexical_score.launches
        kv, ki = lexical_score(qt, qw, dt_, dw_, k, tile_n)
        launches = lexical_score.launches - n0
        pv, pi = lexical_score_plain(qt, qw, dt_, dw_, k, tile_n)
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            raise AssertionError(f"lexical_score/{name}: kernel and plain "
                                 f"differ (must be bit-equal)")
        want = len(plan_chunks(qt.shape[0], qt.shape[1]))
        if launches != want:
            raise AssertionError(f"lexical_score/{name}: {launches} "
                                 f"launches, want {want}")
        rec["cases"][name] = {"max_abs_err": 0.0, "launches": launches,
                              "finite": int(torch.isfinite(kv).sum())}

    (qt1, qw1), (qt64, qw64) = lex_queries(1), lex_queries(64)
    lex_case("B=1,N=500000", qt1, qw1, dt, dw)
    lex_case("B=64,N=500000", qt64, qw64, dt, dw)
    for b in (65, 200):                          # 200: two launches
        lex_case(f"B={b},N=500000", *lex_queries(b), dt, dw)
    for k in (1, MAX_LEX_K):
        lex_case(f"B=64,k={k}", qt64, qw64, dt, dw, k=k)
    # dense enough that the global list fills: fast and slow rounds mixed
    rng_mixed = np.random.default_rng(7)
    dt_mix = torch.as_tensor(rng_mixed.integers(-1, 2000, (200_000, 5)),
                             dtype=torch.int32, device=dev)
    dw_mix = torch.where(dt_mix >= 0, 0.7, 0.0).float()
    lex_case("fast and slow rounds mixed", torch.as_tensor(
        rng_mixed.integers(0, 2000, (64, 2)), dtype=torch.int32, device=dev),
        qw64, dt_mix, dw_mix)
    del dt_mix, dw_mix
    shared = qt64[:8].clone()                    # terms shared by queries
    shared[1:4, 0] = shared[0, 0]
    shared[4, 1] = shared[4, 0]                  # repeated in one query
    lex_case("shared and repeated terms", shared, qw64[:8], dt, dw)
    # > k tied matches over many tiles, plus a tail tile of 163 rows; most
    # tiles' hits overflow the kernel's list
    n_t = 100_003
    dt_tie = torch.randint(0, 6, (n_t, 5), device=dev, generator=g,
                           dtype=torch.int32)
    dt_tie[torch.rand(n_t, 5, device=dev, generator=g) < 0.2] = -1
    dw_tie = torch.where(dt_tie >= 0, 0.7, 0.0).float()
    dw_tie[::3] = torch.where(dt_tie[::3] >= 0, 1.0, 0.0)
    qt_tie = torch.randint(0, 6, (8, 2), device=dev, generator=g,
                           dtype=torch.int32)
    qw_tie = torch.full((8, 2), 0.7, device=dev)
    qt_tie[0, 1], qw_tie[1, 0], qt_tie[2] = -1, 0.0, -1  # -1 terms, 0 weight
    lex_case("ties over 196 tiles + tail tile", qt_tie, qw_tie, dt_tie,
             dw_tie)
    lex_case("ties, tile 256", qt_tie, qw_tie, dt_tie, dw_tie, 256)
    lex_case("ties, tile 99 (unaligned tiles)", qt_tie, qw_tie, dt_tie,
             dw_tie, 99)
    lex_case("ties, B=1", qt_tie[3:4], qw_tie[3:4], dt_tie, dw_tie)
    # back to back, then two streams; the tickets and bitmaps read 0 after
    first = lexical_score(qt64, qw64, dt, dw, K)
    for _ in range(IVF_BACK_TO_BACK - 1):
        last = lexical_score(qt64, qw64, dt, dw, K)
    torch.cuda.synchronize()
    if not (torch.equal(first[0], last[0]) and torch.equal(first[1],
                                                          last[1])):
        raise AssertionError("lexical_score: back-to-back calls differ")
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st, (qt, qw) in zip(streams, ((qt1, qw1), (qt64, qw64))):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(lexical_score(qt, qw, dt_tie, dw_tie, K, 99))
    torch.cuda.synchronize()
    for (qt, qw), (kv, ki) in zip(((qt1, qw1), (qt64, qw64)), outs):
        pv, pi = lexical_score_plain(qt, qw, dt_tie, dw_tie, K, 99)
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            raise AssertionError("lexical_score: two streams differ")
    for (name, _, _), (buf, n_tickets, _) in _build.scratch_cache.items():
        if name == "lexical_score" and \
                buf[:n_tickets].view(torch.int32).any():
            raise AssertionError("lexical_score: a ticket or bitmap word "
                                 "is not 0 after the calls")
    rec["cases"]["200 calls back to back, two streams"] = {
        "max_abs_err": 0.0, "tickets_zero": True}
    for b, qt, qw in ((1, qt1, qw1), (64, qt64, qw64)):
        # what this data needs: every term, the weights of the rows that
        # hold one of the batch's terms, the queries and the outputs; one
        # probe per term
        hit_rows = int(torch.isin(dt, qt[qt >= 0]).any(dim=1).sum())
        n_bytes = dt.numel() * 4 + hit_rows * dt.shape[1] * 4 \
            + qt.numel() * 8 + b * K * 8
        bms, by = bound(n_bytes, dt.numel())
        rec[f"B={b}"] = {
            "hit_rows": hit_rows,
            "ms": timer(lambda: lexical_score(qt, qw, dt, dw, K)),
            "plain_ms": timer(lambda: lexical_score_plain(qt, qw, dt, dw, K),
                              reps=10),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "lexical_score", lambda: lexical_score(qt, qw, dt, dw, K),
                LEXICAL_KERNEL),
            "ctas": plan_grid(-(-dt.shape[0] // 512), 512,
                              _build.sm_count(dev))}
    del dt, dw, dt_tie, dw_tie

    # -- fused_rerank: RRF + diversification + rerank of the pool -----------
    res["fused_rerank"] = check_fused(dev, g, timer)
    return res


def check_fused(dev, g, timer) -> dict:
    """fused_scores (masses, rscores) and fused_rerank (the final top-k in
    the same launch) against their plain versions, one launch a call; the
    split sequence (the scores, then the reference's two stable sorts and
    gathers in launches of their own) timed beside the new one."""
    from repro_torch.kernels.fused_rerank import (final_topk, fused_rerank,
                                                  fused_rerank_plain,
                                                  fused_scores,
                                                  fused_scores_plain)
    from repro_torch.kernels.fused_rerank_probe import pools

    rec = {"cases": {}, "max_abs_err": 0.0, "swaps": 0,
           "near_threshold_rows": 0}

    def fused_case(name, q, ids, vecs, dsim, k=K):
        kd = ids.shape[1] // 2
        km, kr = fused_scores(q, ids, vecs, kd, 60.0, dsim)
        kv, ki = fused_rerank(q, ids, vecs, kd, k, 60.0, dsim)
        pm, pr = fused_scores_plain(q, ids, vecs, kd, 60.0, dsim)
        pv, pi = fused_rerank_plain(q, ids, vecs, kd, k, 60.0, dsim)
        err = float_err(kr, pr, f"fused_rerank/{name} rscore")
        if err > SCORE_TOL:
            raise AssertionError(f"fused_rerank/{name}: rscore error {err}")
        exempt = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
        if dsim is not None:                        # cosines near threshold
            v64 = vecs.double()
            vn = v64 / v64.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            cos = vn @ vn.transpose(1, 2)
            exempt = ((cos - dsim).abs() <= 1e-5).flatten(1).any(dim=1)
        same = (km == pm) | (torch.isneginf(km) & torch.isneginf(pm))
        if not (same.all(dim=1) | exempt).all():
            raise AssertionError(f"fused_rerank/{name}: masses differ")
        if kv.shape != pv.shape or not (
                (kv == pv) | (torch.isneginf(kv) & torch.isneginf(pv))
                ).all(dim=1)[~exempt].all():
            raise AssertionError(f"fused_rerank/{name}: vals differ")
        swaps = 0
        for row, j in (ki != pi).nonzero().tolist():
            if exempt[row]:
                continue
            a = (ids[row] == ki[row, j]).nonzero()[0, 0]
            b = (ids[row] == pi[row, j]).nonzero()[0, 0]
            if abs(float(pr[row, a] - pr[row, b])) > SCORE_TOL:
                raise AssertionError(f"fused_rerank/{name}: id swap at "
                                     f"[{row},{j}] is not a near-tie")
            swaps += 1
        rec["cases"][name] = {"max_abs_err": err, "swaps": swaps,
                              "near_threshold_rows": int(exempt.sum())}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["swaps"] += swaps
        rec["near_threshold_rows"] += int(exempt.sum())

    f1, f64 = pools(1, dev, g), pools(64, dev, g)
    for dsim in (None, 0.98):
        fused_case(f"B=1,dsim={dsim}", *f1, dsim)
        fused_case(f"B=64,dsim={dsim}", *f64, dsim)
    fused_case("B=65,dsim=0.5", *pools(65, dev, g), 0.5)
    for p, k in ((1, 1), (1, 10), (64, 10), (64, 100)):
        fused_case(f"B=64,P={p},k={k},dsim=0.98", *pools(64, dev, g, p), 0.98,
                   k=k)
    fused_case("B=7,P=20,k=25 (> P),dsim=0.98", *pools(7, dev, g), 0.98, k=25)
    fq, fi, fv = pools(8, dev, g)
    fi[0] = -1                                     # nothing retrieved
    fv[0] = 0.0
    fused_case("empty pool, dsim=0.98", fq, fi, fv, 0.98)

    def split_sequence(q, ids, vecs):      # scores, then the sorts
        return final_topk(*fused_scores(q, ids, vecs, K, 60.0, 0.98), ids, K)

    for b, (q, ids, vecs) in ((1, f1), (64, f64)):
        n_bytes = q.numel() * 4 + ids.numel() * 4 + vecs.numel() * 4 \
            + b * K * 8
        ops = b * 2 * (POOL + 1) * (POOL + 2) // 2 * q.shape[1]  # the Gram
        bms, by = bound(n_bytes, ops)
        seq = {}
        for name, fn in (("split", split_sequence),
                         ("one launch", lambda q, i, v: fused_rerank(
                             q, i, v, K, K, 60.0, 0.98))):
            counts = {}
            times = device_times(lambda: fn(q, ids, vecs), 20, counts=counts)
            seq[name] = {"ms": timer(lambda: fn(q, ids, vecs)),
                         "device_us": sum(times.values()),
                         "launches": sum(counts.values())}
        rec[f"B={b}"] = {
            "ms": timer(lambda: fused_rerank(q, ids, vecs, K, K, 60.0,
                                             0.98)),
            "plain_ms": timer(lambda: fused_rerank_plain(q, ids, vecs, K, K,
                                                         60.0, 0.98)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "fused_rerank",
                lambda: fused_rerank(q, ids, vecs, K, K, 60.0, 0.98),
                FUSED_KERNEL),
            "scores_only_device_us": one_launch_us(
                "fused_scores",
                lambda: fused_scores(q, ids, vecs, K, 60.0, 0.98),
                FUSED_KERNEL),
            "split_vs_one_launch": seq}
    return rec


def check_decode_attention(dev, timer) -> dict:
    """Phase 3 for the generator's kernel: decode_attention at the RAG
    decode shape, at decode_32k and long_500k, and at edge cases."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (SIMT_CTAS_PER_SM,
                                                      decode_attention,
                                                      decode_attention_plain,
                                                      plan_chunks, uses_mma)

    g = torch.Generator(device=dev).manual_seed(2)
    h, hkv, d = 32, 2, 128                        # chatglm3-6b
    rec = {"cases": {}, "max_abs_err": 0.0, "tolerance": DECODE_TOL}

    def inputs(b, s, dt=torch.bfloat16, heads=hkv, q_heads=h):
        return (torch.randn(b, q_heads, d, device=dev, generator=g).to(dt),
                torch.randn(b, s, heads, d, device=dev, generator=g).to(dt),
                torch.randn(b, s, heads, d, device=dev, generator=g).to(dt))

    def case(name, q, k, v, clen):
        got = decode_attention(q, k, v, clen)
        want = decode_attention_plain(q, k, v, clen)
        if not torch.isfinite(got).all():
            raise AssertionError(f"decode_attention/{name}: non-finite")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL):
            raise AssertionError(f"decode_attention/{name}: error {err}")
        rec["cases"][name] = {"max_abs_err": err}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    def timing(q, k, v, clen):
        b, s, hkv = k.shape[:3]
        h = q.shape[1]
        n = clen + 1
        elem = k.element_size()
        n_bytes = q.numel() * elem + 2 * b * n * hkv * d * elem + b * h * d * 4
        bms, by = bound(n_bytes, 4 * b * h * n * d, BF16_OPS_PER_S)
        kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                  enable_gqa=True)
        return {"shape": f"B={b}, S={s}, H={h}, Hkv={hkv}, D={d}, "
                         f"cache_len={clen}, {str(k.dtype)[6:]}",
                "ms": timer(lambda: decode_attention(q, k, v, clen)),
                "plain_ms": timer(lambda: decode_attention_plain(q, k, v,
                                                                 clen),
                                  reps=10),
                "library_ms": timer(library, reps=10),
                "bound_ms": bms, "bound_by": by,
                "kernel_device_us": own_kernel_us(device_times(
                    lambda: decode_attention(q, k, v, clen), 20),
                    DECODE_KERNELS),
                "plan": plan_chunks(
                    b * hkv, n, _build.sm_count(dev) * (1 if uses_mma(
                        k.dtype, d, h // hkv) else SIMT_CTAS_PER_SM))}

    s_rag = RAG_PROMPT + RAG_GEN
    q, k, v = inputs(RAG_BATCH, s_rag)
    for clen in (RAG_PROMPT, s_rag - 1, 0):       # first, last decode step
        case(f"RAG B=8 S={s_rag} cache_len={clen}", q, k, v, clen)
    case("RAG, cache_len as a device tensor", q, k, v,
         torch.tensor(s_rag - 1000, device=dev))
    rec["rag"] = timing(q, k, v, s_rag - 1)
    # the other dense configs' groups at the RAG batch and length
    for name, qh, kvh in (("G=4 (phi3-medium-14b: 40/10)", 40, 10),
                          ("G=9 (starcoder2-7b: 36/4)", 36, 4)):
        q, k, v = inputs(RAG_BATCH, s_rag, heads=kvh, q_heads=qh)
        case(f"RAG {name} cache_len={s_rag - 1}", q, k, v, s_rag - 1)
        case(f"RAG {name} cache_len={RAG_PROMPT}", q, k, v, RAG_PROMPT)
    # the MoE configs' groups at the same shape (phase 6b); both take the
    # MMA path, whose tile pads G to 16 rows
    for key, qh in MOE_GROUPS.items():
        q, k, v = inputs(RAG_BATCH, s_rag, heads=8, q_heads=qh)
        for clen in (RAG_PROMPT, s_rag - 1):
            case(f"RAG {key} cache_len={clen}", q, k, v, clen)
        rec[key] = timing(q, k, v, s_rag - 1)
    for name, b, s in (("decode_32k", 128, 32768), ("long_500k", 1, 524288)):
        q, k, v = inputs(b, s)
        case(f"{name} cache_len=S-1", q, k, v, s - 1)
        rec[name] = timing(q, k, v, s - 1)
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = inputs(3, 4099)
    case("S=4099 (not a multiple of the chunk)", q, k, v, 4098)
    case("S=4099, cache_len 0", q, k, v, 0)
    q, k, v = inputs(4, 1000, torch.float32)
    case("f32", q, k, v, 700)
    q, k, v = inputs(2, 1000, torch.float32, heads=h)
    case("f32, Hkv == H (the TPU signature)", q, k, v, 999)
    return {"decode_attention": rec}


def criteo_ids(vocabs, b, gen, dev) -> torch.Tensor:
    """[b, fields] int32 global row ids, uniform within each field."""
    v = torch.tensor(vocabs, dtype=torch.float64, device=dev)
    off = torch.cumsum(v, 0) - v
    u = torch.rand(b, len(vocabs), dtype=torch.float64, device=dev,
                   generator=gen)
    local = torch.minimum((u * v).floor(), v - 1)
    return (off + local).to(torch.int32)


def check_embedding_bag(dev, timer) -> tuple[dict, dict]:
    """Phase 3 for the EmbeddingBag at the repo's Criteo tables, then the
    tables' lookup path through ``embedding_bag_op``."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    from repro_torch.kernels.ops import embedding_bag_op

    g = torch.Generator(device=dev).manual_seed(3)
    rec = {"cases": {}, "max_abs_err": 0.0}
    tables = {}
    for name, (vocabs, dim) in BAG_TABLES.items():
        rows = (sum(vocabs) + 255) // 256 * 256
        tables[name] = (torch.randn(rows, dim, device=dev, generator=g)
                        * 0.05, vocabs)

    def case(name, table, ids, w=None, mode="sum"):
        got = embedding_bag(table, ids, w, mode)
        want = embedding_bag_plain(table, ids, w, mode)
        if got.dtype != table.dtype or not torch.equal(got, want):
            raise AssertionError(f"embedding_bag/{name}: kernel and plain "
                                 f"differ (must be bit-equal)")
        rec["cases"][name] = {"max_abs_err": 0.0}

    for name, (table, vocabs) in tables.items():
        ids = criteo_ids(vocabs, BAG_BATCH, g, dev)
        w = torch.rand(ids.shape, device=dev, generator=g)
        case(f"{name} sum", table, ids)
        case(f"{name} mean", table, ids, mode="mean")
        case(f"{name} weighted", table, ids, w)
        ids64 = ids.long()
        case(f"{name} int64 ids, weighted mean", table, ids64, w, "mean")
        uniq = int(torch.unique(ids).numel())
        n_bytes = uniq * table.shape[1] * 4 + ids.numel() * 4 \
            + BAG_BATCH * table.shape[1] * 4
        bms, by = bound(n_bytes, 2 * ids.numel() * table.shape[1])
        rec[name] = {
            "shape": f"B={BAG_BATCH}, {len(vocabs)} fields, table "
                     f"{table.shape[0]:,} x {table.shape[1]} f32",
            "ms": timer(lambda: embedding_bag(table, ids)),
            "plain_ms": timer(lambda: embedding_bag_plain(table, ids)),
            "library_ms": timer(lambda: F.embedding_bag(ids64, table,
                                                        mode="sum")),
            "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "embedding_bag", lambda: embedding_bag(table, ids),
                BAG_KERNEL),
            "kernel_device_us_int64_ids": one_launch_us(
                "embedding_bag (int64 ids)",
                lambda: embedding_bag(table, ids64), BAG_KERNEL),
            "split": {
                "kernel": host_device_split(lambda: embedding_bag(table,
                                                                  ids)),
                "kernel, int64 ids": host_device_split(
                    lambda: embedding_bag(table, ids64)),
                "F.embedding_bag": host_device_split(
                    lambda: F.embedding_bag(ids64, table, mode="sum"))}}
    table, vocabs = tables["dlrm-rm2"]
    ids = criteo_ids(vocabs, BAG_BATCH, g, dev)
    small = table[:4_000_000].to(torch.bfloat16)
    case("bf16 table, sum", small, ids % small.shape[0])
    case("bf16 table, weighted mean", small, ids % small.shape[0],
         torch.rand(ids.shape, device=dev, generator=g), "mean")
    odd = small[:, :63].contiguous()             # 126-byte rows: 2-byte loads
    case("bf16 table, d=63, int64 ids", odd, (ids % odd.shape[0]).long())
    del small, odd

    # the lookup path: fresh serve_p99 batches through the ops entry point
    embedding_bag.launches = 0
    outs = []
    for name, (table, vocabs) in tables.items():
        for _ in range(BAG_PATH_BATCHES):
            out = embedding_bag_op(table, criteo_ids(vocabs, BAG_BATCH, g,
                                                     dev))
            outs.append(bool(torch.isfinite(out).all()))
    path = {"launches": {"embedding_bag": embedding_bag.launches},
            "batches": len(outs), "finite": all(outs)}
    if path["launches"]["embedding_bag"] != len(outs) or not all(outs):
        raise AssertionError(f"embedding_bag lookup path: {path}")
    return {"embedding_bag": rec}, path


# ---------------------------------------------------------------------------
# Phases 4-5: the two main paths and their plain replays
# ---------------------------------------------------------------------------

class Counters:
    """The launch counts of the six kernels, by kernel name."""

    def __init__(self, table):
        self.table = table            # name -> (wrapper, count attribute)

    def reset(self):
        for fn, attr in self.table.values():
            setattr(fn, attr, 0)

    def read(self) -> dict[str, int]:
        return {n: getattr(fn, attr) for n, (fn, attr) in self.table.items()}


def recording(engine):
    """Keep every (ids, accept, latency, homology) that ``step`` returns."""
    out, step = [], engine.step

    def rec(*a, **kw):
        r = step(*a, **kw)
        out.append(r)
        return r

    engine.step = rec
    return out


def snapshot(state):
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})


def profile_window(step, window, restore=None,
                   accepted=lambda r: bool(r[1])) -> dict:
    """A window of fresh queries (or micro-batches), run once on the host
    clock, then again under the profiler (``restore()`` first puts the
    engine's cache back); ``accepted(step(q))`` counts the accepts."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accepted = sum(accepted(step(q)) for q in window)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / len(window)
    if restore is not None:
        restore()
    counts = {}
    times = device_times(lambda: [step(q) for q in window], 1, warm=False,
                         counts=counts)
    busy = sum(times.values()) / len(window)
    return {"steps": len(window), "accepted": int(accepted),
            "wall_us_per_step": wall_us, "device_busy_us_per_step": busy,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ops_per_step": sum(counts.values()) / len(window),
            "top_kernels_us_per_step": top_ops(times, 10, len(window))}


def top_ops(times: dict[str, float], n: int, per: float) -> dict:
    """The ``n`` largest device times by the first 90 characters of the
    operation's name (names that share them are summed), each over
    ``per``, largest first."""
    short = {}
    for k, v in times.items():
        short[k[:90]] = short.get(k[:90], 0.0) + v / per
    return dict(sorted(short.items(), key=lambda kv: -kv[1])[:n])


@contextlib.contextmanager
def split_sequences():
    """The split launches around the same kernels: validation as the
    scores, then first_argmax and a gather; the cloud stage's fusion as the
    per-slot scores, then the reference's two stable sorts and gathers."""
    from repro_torch.core import has
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_rerank import (final_topk, fused_scores,
                                                  fused_scores_plain)
    from repro_torch.retrieval import fusion
    from repro_torch.utils import first_argmax

    def validate(draft, cache, valid, row_group=None, q_group=None,
                 draft_weights=None, backend=None):
        scores = ops.homology_score_op(draft, cache, valid, row_group,
                                       q_group, draft_weights,
                                       backend=backend)
        slot = first_argmax(scores)
        return (scores, torch.gather(scores, 1, slot[:, None])[:, 0],
                slot.to(torch.int32))

    def rerank(queries, pool_ids, pool_vecs, kd, k, rrf_k=60.0,
               diversify_sim=None, backend=None):
        fn = fused_scores_plain if backend == "torch" else fused_scores
        return final_topk(*fn(queries, pool_ids, pool_vecs, kd, rrf_k,
                              diversify_sim), pool_ids, k)

    saved = has.homology_validate_op, fusion.fused_rerank_op
    has.homology_validate_op, fusion.fused_rerank_op = validate, rerank
    try:
        yield
    finally:
        has.homology_validate_op, fusion.fused_rerank_op = saved


def profile_both(step, window, restore=None) -> tuple[dict, dict]:
    """The window as the port runs it, then split (``split_sequences``),
    each from the same cache snapshot."""
    if restore is not None:
        restore()
    new = profile_window(step, window, restore)
    if restore is not None:
        restore()
    with split_sequences():
        split = profile_window(step, window, restore)
    return new, split


def profile_has(has, window, with_terms: bool) -> tuple[dict, dict]:
    """The HaS engine's window, as is and split, from one cache snapshot."""
    snap = snapshot(has.state)

    def restore():
        has.state = snapshot(snap)

    if with_terms:
        return profile_both(
            lambda q: has.step(q["emb"], q_terms=q["terms"],
                               q_term_weights=q["term_weights"]),
            window, restore)
    return profile_both(lambda q: has.step(q["emb"]), window, restore)


def check_steps(what, steps, summary):
    for ids, _, lat, hom in steps:
        if ids.shape != (K,) or not np.isfinite(lat) or not 0 <= hom <= 1:
            raise AssertionError(f"{what}: malformed step output")
    if not (0 < summary["dar"] < 1 and 0 < summary["doc_hit_rate"] <= 1):
        raise AssertionError(f"{what}: implausible metrics {summary}")


def dense_near_tie(service, q_emb, a_ids, b_ids) -> bool:
    """Every position where two served lists differ holds real,
    unrepeated ids whose f32 corpus scores lie within SCORE_TOL."""
    diff = np.flatnonzero(a_ids != b_ids)
    if (a_ids[diff] < 0).any() or (b_ids[diff] < 0).any():
        return False
    if len(set(a_ids[a_ids >= 0].tolist())) != int((a_ids >= 0).sum()):
        return False
    dev = service.corpus.device
    q = torch.as_tensor(q_emb, device=dev)
    sa = service.corpus[torch.as_tensor(a_ids[diff]).long().to(dev)] @ q
    sb = service.corpus[torch.as_tensor(b_ids[diff]).long().to(dev)] @ q
    return float((sa - sb).abs().max()) <= SCORE_TOL


def algorithm1_path(dev, world, queries, counters) -> dict:
    from repro_torch.core.has import HasConfig
    from repro_torch.retrieval.ivf import build_ivf
    from repro_torch.retrieval.service import RetrievalService
    from repro_torch.serving.engine import FullRetrievalEngine, HasEngine
    from repro_torch.serving.latency import LatencyModel

    info = {}
    service = RetrievalService(world, LatencyModel(), k=K)
    cfg = HasConfig(k=K, tau=0.2, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)
    t0 = time.perf_counter()
    index = build_ivf(service.corpus, cfg.n_buckets, seed=0)
    torch.cuda.synchronize()
    info["ivf_build_s"] = time.perf_counter() - t0
    info["ivf_capacity"] = index.capacity

    counters.reset()
    full = FullRetrievalEngine(service).serve(queries[:FULL_QUERIES])
    has = HasEngine(service, cfg, index=index)
    steps = recording(has)
    t0 = time.perf_counter()
    res = has.serve(queries)
    info["has_serve_s"] = time.perf_counter() - t0
    info["launches"] = counters.read()
    info["full"], info["has"] = full.summary(), res.summary()
    for name in ("topk_search", "ivf_scan", "homology_score"):
        if info["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    check_steps("main path", steps, info["has"])

    window = world.sample_queries(PROFILE_STEPS, **stream_kw(), seed=2)
    info["profile"], info["profile_split"] = profile_has(has, window,
                                                       with_terms=False)
    del steps[HAS_QUERIES:]             # drop the profiled window's steps

    # the same queries through the plain backend, same index
    replay = HasEngine(service, cfg, backend="torch", index=index)
    plain_steps = recording(replay)
    replay.serve(queries[:REPLAY_QUERIES])
    swaps = 0
    for i, (a, b) in enumerate(zip(steps, plain_steps)):
        if a[1] != b[1]:
            raise AssertionError(f"replay: accept differs at query {i}")
        if (a[0] != b[0]).any():
            if not dense_near_tie(service, queries[i]["emb"], a[0], b[0]):
                raise AssertionError(f"replay: ids differ at query {i}")
            swaps += int((a[0] != b[0]).sum())
    info["replay"] = {"queries": len(plain_steps), "accept_equal": True,
                      "near_tie_swaps": swaps,
                      "dar_plain": float(np.mean([s[1] for s in
                                                  plain_steps]))}
    return info, index, service


def int8_score_of(index, q, probe, cvals):
    """score_of(row, id) of the int8 dense channel, recomputed from the
    index (-inf if the id is in no probed bucket)."""
    h = q.shape[1] // 2
    flat_ids = index.bucket_ids.view(-1)

    def score_of(r, gid):
        slot = int((flat_ids == gid).nonzero()[0, 0])
        c, s_ = divmod(slot, index.capacity)
        at = (probe[r] == c).nonzero()
        if not len(at):
            return -float("inf")
        v = index.bucket_vecs[c, s_].float()
        sc = index.bucket_scales[c, s_]
        return float((q[r, :h] @ v[:h]) * sc[0] + (q[r, h:] @ v[h:]) * sc[1]
                     + cvals[r, int(at[0, 0])])

    return score_of


def prove_cloud_near_tie(hybrid, q_rec) -> int:
    """A rejected step served different ids on the two backends: prove that
    the cloud stage's dense channel differs only by near-tied candidates
    (scores recomputed from the int8 index) and that, given the same dense
    list, the kernels reproduce the plain lexical + fusion result."""
    from repro_torch.retrieval.fusion import _fuse_tail, ivf_ann_body
    from repro_torch.utils import stable_topk

    dev = hybrid.corpus.device
    ivf = hybrid._ivf
    q = torch.as_tensor(q_rec["emb"], device=dev)[None].float()
    qt = torch.as_tensor(q_rec["terms"], device=dev)[None].int()
    qw = torch.as_tensor(q_rec["term_weights"], device=dev)[None].float()
    dense = {}
    for be in (None, "torch"):
        dense[be] = ivf_ann_body(ivf.index, ivf._res_vecs, ivf._res_ids, q,
                                 nprobe=ivf.nprobe, k=hybrid.dense_k,
                                 backend=be)
    cvals, probe = stable_topk(q @ ivf.index.centroids.T, ivf.nprobe)
    _, swaps = compare_topk("replay dense channel", *dense[None],
                            *dense["torch"],
                            int8_score_of(ivf.index, q, probe, cvals))
    tails = [_fuse_tail(hybrid.corpus, q, dense["torch"][1], qt, qw,
                        hybrid._terms, hybrid._tw, k=hybrid.k,
                        kl=hybrid.lexical_k, rrf_k=hybrid.rrf_k,
                        diversify_sim=hybrid.diversify_sim, backend=be,
                        tile_n=hybrid.tile_n)[1] for be in (None, "torch")]
    if not torch.equal(*tails):
        raise AssertionError("replay: lexical + fusion differ on the same "
                             "dense list")
    return swaps


def hybrid_path(dev, world, queries, index, counters) -> dict:
    from repro_torch.core.has import HasConfig
    from repro_torch.retrieval.service import HybridBackend, RetrievalService
    from repro_torch.serving.engine import FullRetrievalEngine, HasEngine
    from repro_torch.serving.latency import LatencyModel

    info = {}
    t0 = time.perf_counter()
    hybrid = HybridBackend(world.doc_emb, K, LatencyModel(), world.doc_terms,
                           world.doc_term_weights, **HYBRID)
    torch.cuda.synchronize()
    info["backend_build_s"] = time.perf_counter() - t0
    info["ann_capacity"] = hybrid._ivf.index.capacity
    info["lexical_terms"] = hybrid.lexical_terms
    service = RetrievalService(world, LatencyModel(), k=K, backend=hybrid)
    cfg = HasConfig(k=K, tau=0.2, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768, fusion="rrf")

    counters.reset()
    full = FullRetrievalEngine(service).serve(queries[:FULL_QUERIES])
    has = HasEngine(service, cfg, index=index)
    steps = recording(has)
    t0 = time.perf_counter()
    res = has.serve(queries)
    info["has_serve_s"] = time.perf_counter() - t0
    info["launches"] = counters.read()
    info["full"], info["has"] = full.summary(), res.summary()
    for name in RETRIEVAL_KERNELS:
        if info["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the hybrid "
                                 f"path")
    check_steps("hybrid path", steps, info["has"])

    window = world.sample_queries(PROFILE_STEPS, **stream_kw(), seed=2)
    info["profile"], info["profile_split"] = profile_has(has, window,
                                                       with_terms=True)
    del steps[HAS_QUERIES:]
    # the cloud stage alone: one full_search per fresh query
    info["profile_cloud"], info["profile_cloud_split"] = profile_both(
        lambda q: (service.full_search(q["emb"], q["terms"],
                                       q["term_weights"]), False), window)

    # the same queries with backend="torch" for speculation and cloud stage
    plain = copy.copy(hybrid)
    plain.backend = "torch"
    plain_service = RetrievalService(world, LatencyModel(), k=K,
                                     backend=plain)
    replay = HasEngine(plain_service, cfg, backend="torch", index=index)
    plain_steps = recording(replay)
    replay.serve(queries[:REPLAY_QUERIES])
    swaps = {"draft": 0, "cloud_dense": 0}
    for i, (a, b) in enumerate(zip(steps, plain_steps)):
        if a[1] != b[1]:
            raise AssertionError(f"hybrid replay: accept differs at query "
                                 f"{i}")
        if not (a[0] != b[0]).any():
            continue
        if a[1]:                        # an accepted draft: speculation
            if not dense_near_tie(service, queries[i]["emb"], a[0], b[0]):
                raise AssertionError(f"hybrid replay: draft ids differ at "
                                     f"query {i}")
            swaps["draft"] += int((a[0] != b[0]).sum())
        else:                           # a reject: the cloud stage
            swaps["cloud_dense"] += prove_cloud_near_tie(hybrid, queries[i])
    info["replay"] = {"queries": len(plain_steps), "accept_equal": True,
                      "near_tie_swaps": swaps,
                      "dar_plain": float(np.mean([s[1] for s in
                                                  plain_steps]))}
    return info


# ---------------------------------------------------------------------------
# Phase 7: the micro-batched and tenant-partitioned engine, the baselines
# ---------------------------------------------------------------------------

def record_batches(engine):
    """Keep every (ids, accept) that ``_step_batch`` serves."""
    out, step = [], engine._step_batch

    def rec(group, rng, dataset):
        r = step(group, rng, dataset)
        out.extend((np.asarray(ids), bool(acc)) for ids, acc, _ in r)
        return r

    engine._step_batch = rec
    return out


@contextlib.contextmanager
def spec_recording(first: int):
    """Keep the validation drafts, accept bits and tenant tags of the first
    ``first`` micro-batches the batched engine speculates."""
    from repro_torch.serving import batched
    seen, spec = [], batched.speculate_batch

    def rec(cfg, state, index, q, backend=None, tenant_ids=None):
        out = spec(cfg, state, index, q, backend=backend,
                   tenant_ids=tenant_ids)
        if len(seen) < first:
            seen.append((out["val_ids"].clone(), out["accept"].clone(),
                         tenant_ids.copy()))
        return out

    batched.speculate_batch = rec
    try:
        yield seen
    finally:
        batched.speculate_batch = spec


def tenant_stream(world) -> tuple[list, list]:
    """``sweep_tenants``' stream: per tenant t, granola queries of entities
    ``e % TENANTS == t`` (seed 100 + t), TENANT_QUERIES each, interleaved
    round-robin and tagged."""
    streams = []
    for t in range(TENANTS):
        pool = world.sample_queries(8 * TENANT_QUERIES, **stream_kw(),
                                    seed=100 + t)
        streams.append([dict(q, tenant=t) for q in pool
                        if q["entity"] % TENANTS == t][:TENANT_QUERIES])
    n = min(len(x) for x in streams)
    return [streams[t][i] for i in range(n) for t in range(TENANTS)], streams


def check_served(what, served, summary, lo=0.0):
    for ids, _ in served:
        if ids.shape != (K,):
            raise AssertionError(f"{what}: malformed ids")
    if not (lo < summary["dar"] < 1 and 0 < summary["doc_hit_rate"] <= 1):
        raise AssertionError(f"{what}: implausible metrics {summary}")


def replay_batched(what, service, queries, served, make):
    """The first REPLAY_QUERIES of a batched run again, from the same empty
    cache, through ``make("torch")``: accept bits equal, ids equal up to
    near-ties proven by recomputation."""
    eng = make("torch")
    plain = record_batches(eng)
    eng.serve(queries[:REPLAY_QUERIES])
    swaps = 0
    for i, (a, b) in enumerate(zip(served, plain)):
        if a[1] != b[1]:
            raise AssertionError(f"{what} replay: accept differs at {i}")
        if (a[0] != b[0]).any():
            if not dense_near_tie(service, queries[i]["emb"], a[0], b[0]):
                raise AssertionError(f"{what} replay: ids differ at {i}")
            swaps += int((a[0] != b[0]).sum())
    return {"queries": len(plain), "accept_equal": True,
            "near_tie_swaps": swaps,
            "dar_plain": float(np.mean([p[1] for p in plain]))}


def batched_path(dev, world, queries, service, index, counters) -> dict:
    from repro_torch.core.has import (HasConfig, cache_update_chunked,
                                      intra_batch_share)
    from repro_torch.retrieval.ivf import build_ivf
    from repro_torch.serving.batched import BatchedHasEngine
    from repro_torch.serving.engine import ANNSEngine, HasEngine

    info = {}
    cfg = HasConfig(k=K, tau=TAU, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)

    def make(backend=None, n_tenants=1, cfg_=cfg):
        return BatchedHasEngine(service, cfg_, batch_size=BATCH,
                                backend=backend, n_tenants=n_tenants,
                                index=index)

    # the batched engine at B=32 on phase 4's stream
    counters.reset()
    eng = make()
    served = record_batches(eng)
    t0 = time.perf_counter()
    res = eng.serve(queries)
    torch.cuda.synchronize()
    info["serve_s"] = time.perf_counter() - t0
    info["launches"] = counters.read()
    info["summary"] = res.summary()
    check_served("batched path", served, info["summary"])

    # four tenants on sweep_tenants' stream, the share election recorded
    mixed, streams = tenant_stream(world)
    counters.reset()
    teng = make(n_tenants=TENANTS)
    tserved = record_batches(teng)
    t0 = time.perf_counter()
    with spec_recording(SHARE_BATCHES) as spec_seen:
        tres = teng.serve(mixed)
    torch.cuda.synchronize()
    info["tenant_serve_s"] = time.perf_counter() - t0
    info["tenant_launches"] = counters.read()
    info["tenant_queries"] = len(mixed)
    info["tenant_summary"] = tres.summary()
    tids = np.array([q["tenant"] for q in mixed])
    info["tenant_dar"] = [float(tres.accepts[tids == t].mean())
                          for t in range(TENANTS)]
    check_served("tenant path", tserved, info["tenant_summary"])
    for what, got in (("batched", info["launches"]),
                      ("tenant", info["tenant_launches"])):
        for name in ("topk_search", "ivf_scan", "homology_score"):
            if got[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{what} path")

    # intra_batch_share on the rejected drafts of SHARE_BATCHES of them
    share = {"batches": len(spec_seen), "rejected": 0, "followers": 0,
             "cross_tenant_followers": 0}
    share_tau = SHARE_TAU_MULT * TAU
    for val, acc, tg in spec_seen:
        rej = ~acc
        got = intra_batch_share(val, rej, share_tau, tenant_ids=tg,
                                backend="cuda")
        want = intra_batch_share(val, rej, share_tau, tenant_ids=tg,
                                 backend="torch")
        if not all(torch.equal(got[k_], want[k_]) for k_ in got):
            raise AssertionError("intra_batch_share: cuda and torch differ")
        leader = got["leader"].cpu().numpy()
        follow = leader != np.arange(len(leader))
        share["rejected"] += int(rej.sum())
        share["followers"] += int(follow.sum())
        share["cross_tenant_followers"] += int(
            (tg[leader[follow]] != tg[follow]).sum())
    if share["cross_tenant_followers"]:
        raise AssertionError(f"intra_batch_share: {share}")
    info["share"] = share

    # the leakage audit: fuzzy validation and enhancement off, every id of
    # an accepted draft must be one its tenant paid a full retrieval for
    cfg_nf = dataclasses.replace(cfg, use_fuzzy_validation=False,
                                 use_fuzzy_enhancement=False)
    leng = make(n_tenants=TENANTS, cfg_=cfg_nf)
    lserved = record_batches(leng)
    leng.serve(mixed)
    own = [set() for _ in range(TENANTS)]
    for (ids, acc), t in zip(lserved, tids):
        if not acc:
            own[t].update(int(x) for x in ids if x >= 0)
    leaked = sum(int(x) not in own[t]
                 for (ids, acc), t in zip(lserved, tids) if acc
                 for x in ids if x >= 0)
    audited = sum(acc for _, acc in lserved)
    info["leakage"] = {"leaked_ids": leaked, "audited": int(audited)}
    if leaked or not audited:
        raise AssertionError(f"leakage audit: {info['leakage']}")

    # the replays, from the same (empty) cache with backend="torch"
    info["replay"] = replay_batched("batched", service, queries, served,
                                    make)
    info["tenant_replay"] = replay_batched(
        "tenant", service, mixed, tserved,
        lambda be: make(be, n_tenants=TENANTS))

    # a profiled window of PROFILE_BATCHES fresh micro-batches
    window = world.sample_queries(PROFILE_BATCHES * BATCH, **stream_kw(),
                                  seed=2)
    groups = [window[i:i + BATCH] for i in range(0, len(window), BATCH)]
    snap = snapshot(eng.state)
    rng = np.random.default_rng(0)

    def restore():
        eng.state = snapshot(snap)

    info["profile"] = profile_window(
        lambda grp: eng._step_batch(grp, rng, "granola"), groups, restore,
        accepted=lambda r: sum(a for _, a, _ in r))
    # the ingest alone: the window's first micro-batch as BATCH reject rows,
    # one cache_update_chunked into a snapshot, under the profiler
    embs = np.stack([q["emb"] for q in groups[0]])
    ids, _ = service.full_search_batch(embs)
    st, counts = snapshot(snap), {}
    times = device_times(lambda: cache_update_chunked(
        cfg, st, embs, ids, corpus=service.corpus, chunk=BATCH), 1,
        warm=False, counts=counts)
    info["profile_ingest"] = {
        "rows": len(embs), "device_busy_us": sum(times.values()),
        "device_ops": sum(counts.values()),
        "top_kernels_us": top_ops(times, 6, 1)}

    # the baselines: ANNSEngine in both modes, HaS with the ANNS fallback
    t0 = time.perf_counter()
    ann_index = build_ivf(service.corpus, ANN_BUCKETS, seed=0, device=dev)
    torch.cuda.synchronize()
    info["ann_build_s"] = time.perf_counter() - t0
    base = {}
    anns = {}
    for method in ("ivf", "scann"):
        counters.reset()
        anns[method] = ANNSEngine(service, method, n_buckets=ANN_BUCKETS,
                                  nprobe=64, index=ann_index)
        r = anns[method].serve(queries[:FULL_QUERIES]).summary()
        base[f"anns_{method}"] = {"summary": r,
                                  "launches": counters.read()}
        if base[f"anns_{method}"]["launches"]["ivf_scan"] <= 0 or \
                not 0 < r["doc_hit_rate"] <= 1:
            raise AssertionError(f"ANNSEngine({method}): {r}")
    # the f32 scan's ids against the plain scan's on the same index
    plain = ANNSEngine(service, "ivf", n_buckets=ANN_BUCKETS, nprobe=64,
                       index=ann_index, backend="torch")
    swaps = 0
    for i, q in enumerate(queries[:REPLAY_QUERIES]):
        a, b = anns["ivf"].search(q["emb"])[0], plain.search(q["emb"])[0]
        if (a != b).any():
            if not dense_near_tie(service, q["emb"], a, b):
                raise AssertionError(f"ANNSEngine replay: ids differ at {i}")
            swaps += int((a != b).sum())
    base["anns_replay"] = {"queries": REPLAY_QUERIES, "near_tie_swaps": swaps}
    counters.reset()
    fb = HasEngine(service, cfg, ANNSEngine(service, "ivf",
                                            n_buckets=ANN_BUCKETS, nprobe=64,
                                            index=ann_index), index=index)
    fsteps = recording(fb)
    r = fb.serve(queries[:FULL_QUERIES]).summary()
    base["has_fallback"] = {"summary": r, "launches": counters.read()}
    check_steps("HasEngine(fallback=ANNSEngine)", fsteps, r)
    info["baselines"] = base
    return info


def report_batched(bat: dict) -> None:
    """Phase 7's lines of the log."""
    for title, key, skey in (("batched B=32", "launches", "summary"),
                             (f"tenants T={TENANTS}, B=32", "tenant_launches",
                              "tenant_summary")):
        sm = bat[skey]
        log(f"[{title}] AvgL {sm['avg_latency_s']:.4f} s, DAR "
            f"{sm['dar']:.4f}, CAR {sm['car']:.4f}, DocHit "
            f"{sm['doc_hit_rate']:.4f}, RA {sm['ra_qwen3-8b']:.4f}; "
            f"launches: {bat[key]}")
    log(f"[batched] {HAS_QUERIES} queries in {bat['serve_s']:.1f} s; tenants "
        f"{bat['tenant_queries']} queries ({TENANT_QUERIES} per tenant, "
        f"round-robin) in {bat['tenant_serve_s']:.1f} s, DAR per tenant "
        f"{[round(x, 4) for x in bat['tenant_dar']]}")
    log(f"[tenants] leakage audit (fuzzy V and E off): "
        f"{bat['leakage']['leaked_ids']} leaked ids over "
        f"{bat['leakage']['audited']} accepted drafts; intra_batch_share on "
        f"{bat['share']['batches']} micro-batches ({bat['share']['rejected']}"
        f" rejected, {bat['share']['followers']} followers): cuda equal to "
        f"torch, {bat['share']['cross_tenant_followers']} cross-tenant "
        f"followers")
    pr = bat["profile"]
    log(f"[batched] window of {pr['steps']} fresh micro-batches of {BATCH} "
        f"({pr['accepted']} accepted): {pr['wall_us_per_step']:.1f} "
        f"us/micro-batch wall, device busy "
        f"{pr['device_busy_us_per_step']:.1f} us/micro-batch (profiler), "
        f"{pr['device_ops_per_step']:.1f} device ops/micro-batch, idle share "
        f"{pr['device_idle_share']:.3f}; top kernels us/micro-batch: "
        f"{json.dumps(pr['top_kernels_us_per_step'])}")
    pi = bat["profile_ingest"]
    log(f"[batched] the ingest alone ({pi['rows']} rows, one "
        f"cache_update_chunked): device busy {pi['device_busy_us']:.1f} us, "
        f"{pi['device_ops']:.0f} device ops (profiler); top: "
        f"{json.dumps(pi['top_kernels_us'])}")
    for key in ("replay", "tenant_replay"):
        rp = bat[key]
        log(f"[{key}] {rp['queries']} queries, backend=torch from the same "
            f"empty cache: accept bits equal, near-tie id swaps "
            f"{rp['near_tie_swaps']}")
    for name, b in bat["baselines"].items():
        if name == "anns_replay":
            log(f"[anns_ivf] replay ({b['queries']} queries, "
                f"backend=torch): near-tie id swaps {b['near_tie_swaps']}")
            continue
        sm = b["summary"]
        log(f"[{name}] {FULL_QUERIES} queries: AvgL "
            f"{sm['avg_latency_s']:.4f} s, DAR {sm['dar']:.4f}, DocHit "
            f"{sm['doc_hit_rate']:.4f}, RA {sm['ra_qwen3-8b']:.4f}; "
            f"ivf_scan launches {b['launches']['ivf_scan']}")


def quickstart_twin(dev) -> dict:
    """``examples/quickstart_torch.py`` at its own size on the card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out = mod.run(HAS_QUERIES, device=dev)
    out["s"] = time.perf_counter() - t0
    if not (0 < out["has"]["dar"] < 1 and out["device"].startswith("cuda")):
        raise AssertionError(f"quickstart twin: {out}")
    return out


def rag_twin(dev) -> dict:
    """``examples/rag_serving_torch.py`` at its own size on the card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "rag_serving_torch", ROOT / "examples" / "rag_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out = mod.run(RAG_TWIN_REQUESTS, device=dev)
    s = time.perf_counter() - t0
    res = out["result"]
    n = RAG_TWIN_REQUESTS // mod.BATCH * mod.BATCH
    if res.tokens.shape != (n, mod.GEN_LEN + 1) or \
            not ((0 <= res.tokens) & (res.tokens < mod.GEN_CFG.vocab_size))\
            .all() or not np.isfinite(res.ttft_s).all() or \
            (res.decode_tps <= 0).any() or \
            not out["device"].startswith("cuda"):
        raise AssertionError(f"RAG twin: malformed output on "
                             f"{out['device']}")
    return {"summary": res.summary(), "device": out["device"], "s": s}


# ---------------------------------------------------------------------------
# Phase 8: the continuous-batching scheduler at full width
# ---------------------------------------------------------------------------

def sched_checks(what, sched, res, n) -> dict:
    """The repo's own checks of one scheduler result: every request served
    on a known channel with k ids; spans conserved (residual within 1e-9 s,
    none negative); every full and shared result folded into the primary
    exactly once (its ring pointer counts them); the edge pool's log head
    (lost rows included) agrees."""
    ch = res.channels
    known = ("draft", "reval", "shared", "full", "shed", "degraded",
             "failed")
    if len(ch) != n or not np.isin(ch, known).all() or \
            res.served_ids.shape != (n, K) or \
            not np.isfinite(res.t_done).all():
        raise AssertionError(f"{what}: malformed result")
    resid = float(np.abs(res.trace.conservation_residual()).max()) if n \
        else 0.0
    neg = min(float(res.trace.spans[s].min()) for s in res.trace.spans)
    if resid > 1e-9 or neg < 0:
        raise AssertionError(f"{what}: spans not conserved ({resid}, {neg})")
    folded = int(np.sum(np.isin(ch, ("full", "shared"))))
    q_ptr = sched.state.q_ptr.cpu().numpy()
    if int(q_ptr.sum()) != folded:
        raise AssertionError(f"{what}: {int(q_ptr.sum())} rows folded for "
                             f"{folded} full and shared results")
    pool = sched.edge_pool
    if pool is not None and pool.log.head != folded:
        raise AssertionError(f"{what}: edge log head {pool.log.head} for "
                             f"{folded} folded rows")
    return {"conservation_residual_max": resid, "folded_rows": folded}


def sched_summary(res) -> dict:
    s = res.summary()
    s["channels"] = {str(c): int(np.sum(res.channels == c))
                     for c in np.unique(res.channels)}
    return s


def sched_replay(what, got, want) -> dict:
    """A ``backend="torch"`` replay against the kernels' run: channels,
    accepts, served ids, leader_idx and t_done equal, spans equal."""
    for f in ("channels", "accepts", "served_ids", "leader_idx", "t_done",
              "replica_ids"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if not np.array_equal(a, b):
            first = np.flatnonzero((a != b).reshape(len(a), -1).any(1))[0]
            raise AssertionError(f"{what} replay: {f} differs first at "
                                 f"request {int(first)}")
    for s in got.trace.spans:
        if not np.array_equal(got.trace.spans[s], want.trace.spans[s]):
            raise AssertionError(f"{what} replay: span {s} differs")
    return {"requests": len(got.channels), "equal": True}


def sched_timed(counters, sched, *a, **kw):
    """One ``serve`` with the counts set to 0 just before and read just
    after: (result, wall seconds, launches)."""
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    res = sched.serve(*a, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, counters.read()


def scheduler_path(dev, world, queries, service, index, counters) -> dict:
    import gc

    from repro_torch.core.has import HasConfig, intra_batch_share
    from repro_torch.core.has import speculate_batch
    from repro_torch.serving import scheduler as sched_mod
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig,
                                               poisson_arrivals)

    info = {}
    cfg = HasConfig(k=K, tau=TAU, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)
    n = len(queries)

    def make(cfg_=cfg, **kw):
        return ContinuousBatchingScheduler(
            service, cfg_, SchedulerConfig(**SCHED_KW, **kw), index=index)

    # 1. saturated: every request at t=0; the re-validations and sharing
    # elections are counted, to split homology_score's launches by shape
    sched = make()
    calls = {"revalidate": 0, "share": 0}
    share_fn, reval_fn = sched_mod.intra_batch_share, sched._revalidate

    def share_counted(*a, **kw):
        calls["share"] += 1
        return share_fn(*a, **kw)

    def reval_counted(*a, **kw):
        calls["revalidate"] += 1
        return reval_fn(*a, **kw)

    sched_mod.intra_batch_share, sched._revalidate = share_counted, \
        reval_counted
    try:
        res, wall, launches = sched_timed(counters, sched, queries, None,
                                          seed=0)
    finally:
        sched_mod.intra_batch_share = share_fn
        del sched._revalidate
    for name in ("topk_search", "ivf_scan", "homology_score"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 "scheduler path")
    sat = {"serve_s": wall, "launches": launches, "calls": calls,
           "summary": sched_summary(res),
           **sched_checks("saturated", sched, res, n)}
    if not 0 < sat["summary"]["dar"] < 1:
        raise AssertionError(f"saturated: implausible {sat['summary']}")
    # a window of SCHED_PROFILE speculation dispatches on the scheduler's
    # cache: speculate_batch at B=32, the host copies the loop reads, and
    # the sharing election of its rejects over the registry's shape.  The
    # stream continues: (entity, attr) pairs of served queries, each asked
    # again with fresh noise (another seed's stream has another hot set)
    rng = np.random.default_rng(3)
    fresh = [{"emb": world.encode_query(int(queries[i]["entity"]),
                                        int(queries[i]["attr"]), rng)}
             for i in rng.choice(n, SCHED_PROFILE * BATCH, replace=False)]
    cap = SHARE_ROWS - BATCH
    tau_share = np.float32(SHARE_TAU_MULT * TAU)

    def dispatch(group):
        embs = torch.as_tensor(np.stack([q["emb"] for q in group]),
                               device=dev)
        out = speculate_batch(cfg, sched.state, sched.index, embs)
        acc = out["accept"].cpu().numpy()
        vals = torch.full((SHARE_ROWS, K), -1, dtype=torch.int32,
                          device=dev)
        vals[cap:] = out["val_ids"]
        rej = np.zeros(SHARE_ROWS, bool)
        rej[cap:] = ~acc
        share = intra_batch_share(vals, rej, tau_share,
                                  np.zeros(SHARE_ROWS, bool))
        return int(acc.sum()), share["leader"].cpu().numpy()

    groups = [fresh[i:i + BATCH] for i in range(0, len(fresh), BATCH)]
    walls, accepted = [], []
    for grp in groups:                  # each dispatch on the host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accepted.append(dispatch(grp)[0])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    # the window under the profiler in one session (a session of one
    # dispatch loses its first kernel records at the window's edge)
    sat["profile"] = profile_window(dispatch, groups,
                                    accepted=lambda r: r[0])
    sat["profile"]["wall_us_each"] = walls
    sat["profile"]["accepted_each"] = accepted
    # the same stream through the plain versions on the card
    plain = make(backend="torch")
    res_t, wall_t, _ = sched_timed(counters, plain, queries, None, seed=0)
    sat["replay"] = sched_replay("saturated", res_t, res)
    sat["replay"]["serve_s"] = wall_t
    info["saturated"] = sat
    del plain, res_t
    gc.collect()

    # 2. Poisson arrivals at the reference's qps_saturating
    qps = BATCH / sched._spec_time(BATCH)
    arr = poisson_arrivals(n, qps=qps, seed=7)
    res, wall, launches = sched_timed(counters, sched, queries, arr, seed=0)
    info["poisson"] = {"qps": qps, "serve_s": wall, "launches": launches,
                       "summary": sched_summary(res),
                       **sched_checks("poisson", sched, res, n)}
    del sched
    gc.collect()

    # 3. four tenants on sweep_tenants' stream, the leakage audit on a
    # fuzzy-off run, and a torch replay
    mixed, _ = tenant_stream(world)
    tids = np.array([q["tenant"] for q in mixed], np.int32)
    ten = make(n_tenants=TENANTS)
    res, wall, launches = sched_timed(counters, ten, mixed, None, seed=0,
                                      tenant_ids=tids)
    tinfo = {"queries": len(mixed), "serve_s": wall, "launches": launches,
             "summary": sched_summary(res),
             "per_tenant": {int(t): v for t, v in res.per_tenant().items()},
             **sched_checks("tenants", ten, res, len(mixed))}
    del ten
    plain = make(n_tenants=TENANTS, backend="torch")
    res_t, wall_t, _ = sched_timed(counters, plain, mixed, None, seed=0,
                                   tenant_ids=tids)
    tinfo["replay"] = sched_replay("tenants", res_t, res)
    tinfo["replay"]["serve_s"] = wall_t
    del plain, res_t
    cfg_nf = dataclasses.replace(cfg, use_fuzzy_validation=False,
                                 use_fuzzy_enhancement=False)
    leak = make(cfg_nf, n_tenants=TENANTS)
    rl = leak.serve(mixed, None, seed=0, tenant_ids=tids)
    own = [set() for _ in range(TENANTS)]
    for i in np.flatnonzero(rl.channels == "full"):
        own[int(tids[i])].update(int(x) for x in rl.served_ids[i] if x >= 0)
    acc = np.flatnonzero(np.isin(rl.channels, ("draft", "reval", "shared")))
    leaked = sum(int(x) not in own[int(tids[i])]
                 for i in acc for x in rl.served_ids[i] if x >= 0)
    sh = np.flatnonzero(rl.channels == "shared")
    cross = int(np.sum(rl.tenant_ids[rl.leader_idx[sh]]
                       != rl.tenant_ids[sh]))
    tinfo["leakage"] = {"leaked_ids": leaked, "audited": int(len(acc)),
                        "cross_tenant_followers": cross,
                        "followers": int(len(sh))}
    if leaked or cross or not len(acc):
        raise AssertionError(f"scheduler leakage audit: {tinfo['leakage']}")
    info["tenants"] = tinfo
    del leak
    gc.collect()

    # 4. faults: three edge replicas, every fault kind, timed off the
    # fault-free makespan as the reference's chaos benchmark times them;
    # the cloud events go to the lone LocalFlatBackend worker
    nf = min(n, CHAOS_QUERIES)
    kw = dict(edge_replicas=3, retry_max=3, retry_backoff_s=0.3)
    base = make(**kw)
    arr = poisson_arrivals(nf, qps=0.8 * BATCH / base._spec_time(BATCH),
                           seed=11)
    r_ff, wall_ff, l_ff = sched_timed(counters, base, queries[:nf], arr,
                                      seed=0)
    ff_checks = sched_checks("fault-free", base, r_ff, nf)
    m = float(r_ff.summary()["makespan_s"])
    del base
    plan = FaultPlan(events=(
        FaultEvent(t=round(0.15 * m, 6), kind="straggler", target=0,
                   duration_s=round(0.20 * m, 6), factor=6.0),
        FaultEvent(t=round(0.25 * m, 6), kind="worker_crash", target=0,
                   down_s=round(0.15 * m, 6)),
        FaultEvent(t=round(0.30 * m, 6), kind="delta_drop", count=2),
        FaultEvent(t=round(0.40 * m, 6), kind="search_fail", target=0,
                   duration_s=round(0.10 * m, 6)),
        FaultEvent(t=round(0.50 * m, 6), kind="replica_crash", target=1),
        FaultEvent(t=round(0.60 * m, 6), kind="delta_dup", count=2)))
    chaos = make(**kw, fault_plan=plan)
    res, wall, launches = sched_timed(counters, chaos, queries[:nf], arr,
                                      seed=0)
    s = sched_summary(res)
    info["faults"] = {
        "queries": nf, "plan": [dataclasses.asdict(e) for e in plan.events],
        "fault_free": {"serve_s": wall_ff, "launches": l_ff,
                       "summary": sched_summary(r_ff), **ff_checks},
        "serve_s": wall, "launches": launches, "summary": s,
        "lost_s": float(res.trace.spans["lost"].sum()),
        "retry_backoff_s": float(res.trace.spans["retry_backoff"].sum()),
        **sched_checks("faults", chaos, res, nf)}
    if s["worker_deaths"] != 1 or s["replica_rebuilds"] < 1 or \
            s["retries"] < 1:
        raise AssertionError(f"fault plan did not engage: {s}")
    del chaos
    gc.collect()

    # 5. overload: shed and degrade at 4x the edge rate, SLO 2.5x the
    # unloaded reject path (the reference's overload sweep)
    base = make()
    lat = service.latency
    spec_svc = base._spec_time(BATCH)
    reject_path = (spec_svc + 0.5 * sum(lat.edge_rtt)
                   + base._full_time(SCHED_KW["full_batch"])
                   + 0.5 * sum(lat.cloud_rtt))
    slo = 2.5 * reject_path
    qps = 4.0 * BATCH / spec_svc
    arr = poisson_arrivals(n, qps=qps, seed=11)
    del base
    over = {"slo_s": slo, "qps": qps}
    for policy in ("shed", "degrade"):
        sch = make(slo_deadline_s=slo, overload_policy=policy)
        res, wall, launches = sched_timed(counters, sch, queries, arr,
                                          seed=0)
        over[policy] = {"serve_s": wall, "launches": launches,
                        "summary": sched_summary(res),
                        **sched_checks(policy, sch, res, n)}
        key = "shed" if policy == "shed" else "degraded"
        if over[policy]["summary"][key] <= 0:
            raise AssertionError(f"overload {policy}: nothing {key}")
        del sch
        gc.collect()
    info["overload"] = over
    return info


def report_scheduler(sp: dict) -> None:
    """Phase 8's lines of the log."""
    def line(title, r, extra=""):
        s = r["summary"]
        log(f"[scheduler {title}] modelled (virtual clock): throughput "
            f"{s['throughput_qps']:.2f} qps, p50/p95/p99 "
            f"{s['p50_latency_s'] * 1e3:.1f} / {s['p95_latency_s'] * 1e3:.1f}"
            f" / {s['p99_latency_s'] * 1e3:.1f} ms, DAR {s['dar']:.4f}, CAR "
            f"{s['car']:.4f}, DocHit {s['doc_hit_rate']:.4f}, full "
            f"retrievals {s['full_retrievals']}, shared {s['shared_accepts']}"
            f", reval {s['reval_accepts']}, channels {s['channels']}; "
            f"{s['spec_batches']} speculation and {s['full_batches']} full "
            f"batches; serve wall {r['serve_s']:.2f} s; launches "
            f"{r['launches']}{extra}")

    sat = sp["saturated"]
    line("saturated", sat, f"; homology_score launches: "
         f"{sat['summary']['spec_batches']} validations (B={BATCH}), "
         f"{sat['calls']['revalidate']} re-validations (B={REVAL_BATCH}), "
         f"{sat['calls']['share']} sharing elections ({SHARE_ROWS} x "
         f"{SHARE_ROWS})")
    pr = sat["profile"]
    log(f"[scheduler] {pr['steps']} speculation dispatches (B={BATCH} "
        f"speculate_batch + the sharing election over {SHARE_ROWS} rows; "
        f"accepted {pr['accepted_each']}): wall each "
        f"{[round(w, 1) for w in pr['wall_us_each']]} us; per dispatch "
        f"wall {pr['wall_us_per_step']:.1f} us, device busy "
        f"{pr['device_busy_us_per_step']:.1f} us (profiler), "
        f"{pr['device_ops_per_step']:.1f} device ops, idle share "
        f"{pr['device_idle_share']:.3f}; top us per dispatch: "
        f"{json.dumps(pr['top_kernels_us_per_step'])}")
    log(f"[scheduler saturated] backend=torch replay: channels, accepts, "
        f"served ids, leader_idx, replica ids, t_done and every span equal "
        f"({sat['replay']['requests']} requests, {sat['replay']['serve_s']:.2f}"
        f" s); spans conserved within {sat['conservation_residual_max']:.3g}"
        f" s; {sat['folded_rows']} rows folded once each")
    line(f"Poisson {sp['poisson']['qps']:.2f} qps", sp["poisson"])
    t = sp["tenants"]
    line(f"tenants T={TENANTS}", t,
         f"; per-tenant DAR {[round(v['dar'], 4) for v in t['per_tenant'].values()]}")
    lk = t["leakage"]
    log(f"[scheduler tenants] leakage audit (fuzzy V and E off): "
        f"{lk['leaked_ids']} leaked ids over {lk['audited']} accepted, "
        f"{lk['cross_tenant_followers']} cross-tenant followers of "
        f"{lk['followers']}; backend=torch replay equal "
        f"({t['replay']['serve_s']:.2f} s)")
    f = sp["faults"]
    s = f["summary"]
    line(f"fault-free (R=3, {f['queries']} queries)", f["fault_free"])
    line("faults (every kind)", f,
         f"; retries {s['retries']}, hedges {s['hedges']}, replica rebuilds "
         f"{s['replica_rebuilds']}, worker deaths {s['worker_deaths']}, "
         f"failed {s['failed']}; lost {f['lost_s']:.3f} s, backoff "
         f"{f['retry_backoff_s']:.3f} s; spans conserved within "
         f"{f['conservation_residual_max']:.3g} s; {f['folded_rows']} rows "
         f"folded once each")
    o = sp["overload"]
    for policy in ("shed", "degrade"):
        s = o[policy]["summary"]
        line(f"overload {policy} ({o['qps']:.1f} qps, SLO {o['slo_s']:.3f} "
             f"s)", o[policy],
             f"; shed {s['shed']}, degraded {s['degraded']}, p99 admitted "
             f"{s['p99_admitted_latency_s'] * 1e3:.1f} ms, goodput "
             f"{s['goodput_qps']:.2f} qps, SLO attainment "
             f"{s['slo_attainment']:.4f}")


def decode_run(params, cfg, prompt, backend, feed=None):
    """One batch through prefill and RAG_GEN greedy decode steps, keeping
    every step's logits (f32): (tokens [B, RAG_GEN+1], logits).  With
    ``feed`` (another run's tokens) step j takes ``feed[:, j]`` as its
    input instead of its own greedy token."""
    from repro_torch.models import transformer as tf
    from repro_torch.utils import first_argmax

    b, n = prompt.shape
    lg = tf.prefill(params, prompt, cfg)
    cache = tf.init_kv_cache(cfg, b, n + RAG_GEN, device=prompt.device)
    toks, logits = [first_argmax(lg).int()], [lg.float()]
    for j in range(RAG_GEN):
        tok = toks[-1] if feed is None else feed[:, j]
        lg, cache = tf.decode_step(params, cache, tok, n + j, cfg,
                                   backend=backend)
        toks.append(first_argmax(lg).int())
        logits.append(lg.float())
    return torch.stack(toks, 1), torch.stack(logits, 1)


def compare_greedy(tk, lk, tp, lp) -> dict:
    """Kernel run (tk, lk) vs plain run (tp, lp) of one batch.  While a
    row's tokens agree its logits must agree within LOGIT_TOL; where they
    first part, the two tokens must be a near-tie in both runs (logits
    within LOGIT_TOL).  The row is then left out: its inputs differ."""
    tk, tp = tk.cpu(), tp.cpu()
    max_err, parted = 0.0, []
    for row in range(tk.shape[0]):
        diff = (tk[row] != tp[row]).nonzero()
        stop = int(diff[0, 0]) if len(diff) else tk.shape[1]
        upto = min(stop + 1, tk.shape[1])        # the parting step included
        err = float((lk[row, :upto] - lp[row, :upto]).abs().max())
        max_err = max(max_err, err)
        if err > LOGIT_TOL:
            raise AssertionError(f"RAG replay: logits of row {row} differ by "
                                 f"{err}")
        if stop < tk.shape[1]:
            a, b = int(tk[row, stop]), int(tp[row, stop])
            gaps = [float((lg[row, stop, a] - lg[row, stop, b]).abs())
                    for lg in (lk, lp)]
            if max(gaps) > LOGIT_TOL:
                raise AssertionError(f"RAG replay: tokens {a} vs {b} at row "
                                     f"{row}, step {stop} are not a "
                                     f"near-tie ({gaps})")
            parted.append({"row": row, "step": stop, "tokens": [a, b],
                           "logit_gaps": gaps})
    return {"max_logit_err": max_err, "logit_tol": LOGIT_TOL,
            "parted_rows": parted,
            "tokens_equal": int((tk == tp).all(dim=1).sum())}


def rag_path(dev, world, service, index, counters) -> dict:
    from repro_torch.configs.lm_archs import LM_CONFIGS
    from repro_torch.core.has import HasConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import HasEngine
    from repro_torch.serving.rag import build_prompt, serve_rag

    info = {}
    cfg = LM_CONFIGS["chatglm3-6b"]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    info["init_params_s"] = time.perf_counter() - t0
    info["params"] = cfg.param_count()
    engine = HasEngine(service, HasConfig(k=K, tau=0.2, h_max=5000,
                                          doc_capacity=50_000, nprobe=64,
                                          n_buckets=8192, d=768),
                       index=index)
    queries = world.sample_queries(RAG_REQUESTS, **stream_kw(), seed=3)

    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve_rag(engine, queries, params, cfg, batch=RAG_BATCH,
                    prompt_len=RAG_PROMPT, gen_len=RAG_GEN)
    info["serve_s"] = time.perf_counter() - t0
    info["launches"] = counters.read()
    info["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.n_layers * RAG_GEN * (RAG_REQUESTS // RAG_BATCH)
    if info["launches"]["decode_attention"] != want:
        raise AssertionError(f"decode_attention launched "
                             f"{info['launches']['decode_attention']} times "
                             f"on the RAG path, want {want}")
    for name in ("topk_search", "ivf_scan", "homology_score"):
        if info["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the RAG path")
    if res.tokens.shape != (RAG_REQUESTS, RAG_GEN + 1) or \
            res.ids.shape != (RAG_REQUESTS, K) or \
            not ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all() or \
            not np.isfinite(res.ttft_s).all() or (res.decode_tps <= 0).any():
        raise AssertionError("RAG path: malformed output")
    info["summary"] = res.summary()
    info["ttft_s"] = res.ttft_s.tolist()
    info["decode_tps"] = res.decode_tps.tolist()
    info["distinct_tokens"] = int(len(np.unique(res.tokens)))

    # one batch again: its decode window profiled, then each backend
    prompt = torch.as_tensor(
        build_prompt(queries[:RAG_BATCH], res.ids[:RAG_BATCH], RAG_PROMPT),
        dtype=torch.int32, device=dev)
    info["profile"], info["prefill_profile"] = profile_generator(
        params, cfg, prompt)
    tk, lk = decode_run(params, cfg, prompt, None)
    if not torch.equal(tk.cpu(), torch.as_tensor(res.tokens[:RAG_BATCH])):
        raise AssertionError("RAG replay: the kernel run does not repeat "
                             "serve_rag's tokens")
    tp, lp = decode_run(params, cfg, prompt, "torch")
    info["replay"] = compare_greedy(tk, lk, tp, lp)
    del params
    torch.cuda.empty_cache()
    return info


def profile_generator(params, cfg, prompt) -> tuple[dict, dict]:
    """One batch's decode window (RAG_GEN greedy steps from a fresh cache,
    after the prefill's token) on the host clock and under the profiler,
    then one prefill under the profiler."""
    from repro_torch.models import transformer as tf
    from repro_torch.utils import first_argmax

    b = prompt.shape[0]
    first = first_argmax(tf.prefill(params, prompt, cfg)).int()

    def window():
        cache = tf.init_kv_cache(cfg, b, RAG_PROMPT + RAG_GEN,
                                 device=prompt.device)
        tok = first
        for j in range(RAG_GEN):
            lg, cache = tf.decode_step(params, cache, tok, RAG_PROMPT + j,
                                       cfg)
            tok = first_argmax(lg).int()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / RAG_GEN
    counts = {}
    times = device_times(window, 1, warm=False, counts=counts)
    busy = sum(times.values()) / RAG_GEN
    profile = {
        "steps": RAG_GEN, "wall_us_per_step": wall_us,
        "device_busy_us_per_step": busy,
        "device_idle_share": 1.0 - busy / wall_us,
        "launches_per_step": sum(counts.values()) / RAG_GEN,
        "decode_attention_us_per_step": own_kernel_us(
            times, DECODE_KERNELS)
        / RAG_GEN,
        "top_kernels_us_per_step": top_ops(times, 10, RAG_GEN)}
    pre = device_times(lambda: tf.prefill(params, prompt, cfg), 1)
    return profile, {"device_busy_ms": sum(pre.values()) / 1e3,
                     "top_kernels_ms": top_ops(pre, 8, 1e3)}


# ---------------------------------------------------------------------------
# Phase 6b: the MoE generators at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_tap(calls: list):
    """Keep (layer params, x, out) of every decode call of the MoE layer
    (one token a row), in call order: step-major, layer-minor."""
    from repro_torch.models import layers as L
    moe = L.moe

    def tapped(params, x, **kw):
        out, aux = moe(params, x, **kw)
        if x.shape[1] == 1:
            calls.append((params, x.clone(), out.clone()))
        return out, aux

    L.moe = tapped
    try:
        yield
    finally:
        L.moe = moe


def moe_decisions(cfg, calls) -> list[dict]:
    """Each tapped call's routing as the layer computes it (the same
    ``_moe_dispatch`` on the same input): per token its experts
    (ascending), kept and zeroed flags (zeroed: kept at position 0 of an
    expert that dropped an entry), its f32 router logits; the dropped
    (token, slot) pairs, the zeroed tokens and the capacity."""
    from repro_torch.models import layers as L

    e, k = cfg.moe_experts, cfg.moe_top_k
    out = []
    for params, x, _ in calls:
        xt = x.reshape(-1, x.shape[-1])
        cap = int(cfg.capacity_factor * xt.shape[0] * k / e) + 1
        _, r, _ = L._moe_dispatch(xt, params["router"], k, cap, e)
        experts = r.gate_idx.sort(dim=1).values
        kept = r.keep[r.add_order]
        zeroed = kept & (r.slot[r.add_order] % cap == 0) & r.overflow[experts]
        out.append({"experts": experts.cpu(), "kept": kept.cpu(),
                    "zeroed": zeroed.cpu(),
                    "logits": (xt.float() @ params["router"].float()).cpu(),
                    "dropped": int((~r.keep).sum()),
                    "zeroed_tokens": int(zeroed.sum()), "capacity": cap})
    return out


def moe_plain_loop(cfg, params, x) -> tuple[torch.Tensor, dict]:
    """The MoE layer as a plain loop in f32 (``tests/test_models.py:75-98``
    with the capacity rule): each token's top-k experts (ties to the lower
    index) with renormalised weights; entries taken expert by expert in
    token order, those past the capacity dropped; an expert that drops an
    entry gives its first token nothing; each kept entry's SwiGLU through
    the expert's weights widened to f32."""
    from repro_torch.models import layers as L

    xt = x.reshape(-1, x.shape[-1]).float()
    t, e, k = xt.shape[0], cfg.moe_experts, cfg.moe_top_k
    cap = int(cfg.capacity_factor * t * k / e) + 1
    probs = torch.softmax(xt @ params["router"].float(), -1).cpu()
    entries = []
    for tok in range(t):
        ids = sorted(range(e), key=lambda j: (-float(probs[tok, j]), j))[:k]
        w = probs[tok, ids] / probs[tok, ids].sum()
        entries += [(ex, tok, float(wi)) for ex, wi in zip(ids, w)]
    seen, first, over, kept = {}, {}, set(), []
    for ex, tok, w in sorted(entries, key=lambda en: (en[0], en[1])):
        n = seen.get(ex, 0)
        if n >= cap:
            over.add(ex)
            continue
        first.setdefault(ex, tok)
        seen[ex] = n + 1
        kept.append((ex, tok, w))
    out = torch.zeros_like(xt)
    for ex, tok, w in kept:
        if ex in over and first[ex] == tok:
            continue
        h = L.silu(xt[tok] @ params["w_gate"][ex].float()) * (
            xt[tok] @ params["w_in"][ex].float())
        out[tok] += w * (h @ params["w_out"][ex].float())
    return out, {"dropped": len(entries) - len(kept), "zeroed_tokens":
                 len(over), "capacity": cap}


def compare_moe_greedy(n_layers, tk, lk, tp, lp, dk, dp) -> dict:
    """Kernel run (tk, lk) vs plain run (tp, lp) of one batch through an
    MoE generator, the plain run fed the kernel run's tokens, so both take
    the same input at every step.  Where a row's greedy tokens differ, the
    two tokens must be a near-tie of the logits in both runs (LOGIT_TOL),
    as ``compare_greedy`` checks them.  The rows of a batch share the
    experts' capacity, so a row is compared while, in every layer, its
    experts and its kept and zeroed flags agree, and leaves where one of
    them first parts:
    - its experts differ: the swapped experts' router logits must lie
      within ROUTER_TOL in both runs (a near-tie of the routing);
    - only its flags differ: another row's experts must differ in that
      layer (the capacity then orders other tokens).
    While it is compared its logits agree within LOGIT_TOL."""
    tk, tp = tk.cpu(), tp.cpu()
    b, n = tk.shape
    alive, ended, ties = set(range(b)), {}, []
    max_err, router_err = 0.0, 0.0
    for i in range(n):
        for layer in range(n_layers if i else 0):
            ck, cp = dk[(i - 1) * n_layers + layer], dp[(i - 1) * n_layers
                                                        + layer]
            moved = {r for r in range(b)
                     if not torch.equal(ck["experts"][r], cp["experts"][r])}
            for r in sorted(alive):
                if r in moved:
                    a = set(ck["experts"][r].tolist())
                    c = set(cp["experts"][r].tolist())
                    gaps = [max(abs(float(lg[r, x] - lg[r, y]))
                                for x in a - c for y in c - a)
                            for lg in (ck["logits"], cp["logits"])]
                    if max(gaps) > ROUTER_TOL:
                        raise AssertionError(
                            f"MoE replay: row {r} step {i - 1} layer {layer}"
                            f" routes to {sorted(a)} vs {sorted(c)}, not a "
                            f"near-tie ({gaps})")
                    ended[r] = {"index": i, "layer": layer,
                                "why": "routing near-tie",
                                "experts": [sorted(a), sorted(c)],
                                "router_logit_gaps": gaps}
                elif not (torch.equal(ck["kept"][r], cp["kept"][r])
                          and torch.equal(ck["zeroed"][r], cp["zeroed"][r])):
                    if not moved:
                        raise AssertionError(
                            f"MoE replay: row {r} step {i - 1} layer {layer}"
                            f": capacity decisions differ on equal routing")
                    ended[r] = {"index": i, "layer": layer,
                                "why": "capacity shared with rows "
                                       f"{sorted(moved)}"}
                else:
                    router_err = max(router_err, float(
                        (ck["logits"][r] - cp["logits"][r]).abs().max()))
                    continue
                alive.discard(r)
        for r in sorted(alive):
            err = float((lk[r, i] - lp[r, i]).abs().max())
            max_err = max(max_err, err)
            if err > LOGIT_TOL:
                raise AssertionError(f"MoE replay: logits of row {r} at "
                                     f"{i} differ by {err}")
            if tk[r, i] != tp[r, i]:
                x, y = int(tk[r, i]), int(tp[r, i])
                gaps = [float((lg[r, i, x] - lg[r, i, y]).abs())
                        for lg in (lk, lp)]
                if max(gaps) > LOGIT_TOL:
                    raise AssertionError(f"MoE replay: tokens {x} vs {y} at "
                                         f"row {r}, index {i} are not a "
                                         f"near-tie ({gaps})")
                ties.append({"row": r, "index": i, "tokens": [x, y],
                             "logit_gaps": gaps})
    compared = sum(ended.get(r, {"index": n})["index"] for r in range(b))
    return {"max_logit_err": max_err, "logit_tol": LOGIT_TOL,
            "max_router_logit_err": router_err, "router_tol": ROUTER_TOL,
            "rows_to_the_end": len(alive), "ended": ended,
            "positions_compared": compared,
            "tokens_equal": compared - len(ties), "logit_near_ties": ties}


def tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(map(tree_bytes, tree.values() if isinstance(tree, dict)
                   else tree))


def moe_arch_path(dev, world, service, index, counters, name,
                  n_layers) -> dict:
    """One MoE generator, full width, ``n_layers`` deep, behind a fresh
    ``HasEngine`` on phase 4's world and index."""
    from repro_torch.configs.lm_archs import LM_CONFIGS
    from repro_torch.core.has import HasConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import HasEngine
    from repro_torch.serving.rag import build_prompt, serve_rag

    cfg = dataclasses.replace(LM_CONFIGS[name], n_layers=n_layers)
    info = {"layers": n_layers, "of_layers": LM_CONFIGS[name].n_layers,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    info["init_params_s"] = time.perf_counter() - t0
    info["weights_gb"] = tree_bytes(params) / 1e9
    engine = HasEngine(service, HasConfig(k=K, tau=0.2, h_max=5000,
                                          doc_capacity=50_000, nprobe=64,
                                          n_buckets=8192, d=768),
                       index=index)
    queries = world.sample_queries(MOE_REQUESTS, **stream_kw(), seed=4)

    counters.reset()
    t0 = time.perf_counter()
    res = serve_rag(engine, queries, params, cfg, batch=RAG_BATCH,
                    prompt_len=RAG_PROMPT, gen_len=RAG_GEN)
    info["serve_s"] = time.perf_counter() - t0
    info["launches"] = counters.read()
    want = n_layers * RAG_GEN * (MOE_REQUESTS // RAG_BATCH)
    if info["launches"]["decode_attention"] != want:
        raise AssertionError(f"{name}: decode_attention launched "
                             f"{info['launches']['decode_attention']} times,"
                             f" want {want}")
    for kname in ("topk_search", "ivf_scan", "homology_score"):
        if info["launches"][kname] <= 0:
            raise AssertionError(f"{name}: {kname} was not launched")
    if res.tokens.shape != (MOE_REQUESTS, RAG_GEN + 1) or \
            res.ids.shape != (MOE_REQUESTS, K) or \
            not ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all() or \
            not np.isfinite(res.ttft_s).all() or (res.decode_tps <= 0).any():
        raise AssertionError(f"{name}: malformed output")
    info["summary"] = res.summary()
    info["ttft_s"] = res.ttft_s.tolist()
    info["decode_tps"] = res.decode_tps.tolist()
    info["distinct_tokens"] = int(len(np.unique(res.tokens)))

    prompt = torch.as_tensor(
        build_prompt(queries[:RAG_BATCH], res.ids[:RAG_BATCH], RAG_PROMPT),
        dtype=torch.int32, device=dev)
    info["profile"], info["prefill_profile"] = profile_generator(
        params, cfg, prompt)
    calls_k, calls_p = [], []
    with moe_tap(calls_k):
        tk, lk = decode_run(params, cfg, prompt, None)
    if not torch.equal(tk.cpu(), torch.as_tensor(res.tokens[:RAG_BATCH])):
        raise AssertionError(f"{name}: the kernel run does not repeat "
                             "serve_rag's tokens")
    with moe_tap(calls_p):
        tp, lp = decode_run(params, cfg, prompt, "torch", feed=tk)
    if not len(calls_k) == len(calls_p) == n_layers * RAG_GEN:
        raise AssertionError(f"{name}: {len(calls_k)} MoE decode calls")
    dk, dp = moe_decisions(cfg, calls_k), moe_decisions(cfg, calls_p)
    info["replay"] = compare_moe_greedy(n_layers, tk, lk, tp, lp, dk, dp)
    steps = [dk[j * n_layers:(j + 1) * n_layers] for j in range(RAG_GEN)]
    info["routing"] = {
        "capacity": dk[0]["capacity"],
        "dropped_per_step": [[d["dropped"] for d in st] for st in steps],
        "zeroed_per_step": [[d["zeroed_tokens"] for d in st]
                            for st in steps],
        "entries_per_layer_step": RAG_BATCH * cfg.moe_top_k}

    # the layer at full width against the plain loop: decode step 0, layer 0
    lp0, x0, out0 = calls_k[0]
    want_out, plain = moe_plain_loop(cfg, lp0, x0)
    err = float((out0.reshape(want_out.shape).float() - want_out)
                .abs().max())
    if not torch.isfinite(out0).all() or err > MOE_TOL:
        raise AssertionError(f"{name}: the MoE layer differs from the plain "
                             f"loop by {err}")
    for key in ("dropped", "zeroed_tokens", "capacity"):
        if plain[key] != dk[0][key]:
            raise AssertionError(f"{name}: plain loop {key} {plain[key]}, "
                                 f"the layer's {dk[0][key]}")
    info["plain_loop"] = dict(plain, max_abs_err=err, tolerance=MOE_TOL,
                              max_abs_out=float(want_out.abs().max()))
    info["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, calls_k, calls_p, lp0, x0, out0
    torch.cuda.empty_cache()
    return info


def moe_path(dev, world, service, index, counters) -> dict:
    """Phase 6b: dbrx-132b, then arctic-480b (each freed before the
    next)."""
    return {name: moe_arch_path(dev, world, service, index, counters, name,
                                n_layers)
            for name, n_layers in MOE_ARCHS.items()}


def report_moe(moe: dict) -> None:
    for name, m in moe.items():
        sm, pr, pp, rp = (m["summary"], m["profile"], m["prefill_profile"],
                          m["replay"])
        rt, pl = m["routing"], m["plain_loop"]
        log(f"[MoE {name}] full width, {m['layers']} of {m['of_layers']} "
            f"layers ({m['params'] / 1e9:.2f} B params, "
            f"{m['active_params'] / 1e9:.2f} B active, bf16, "
            f"{m['weights_gb']:.1f} GB on the card; weights drawn in "
            f"{m['init_params_s']:.1f} s): {sm['requests']} requests, batch "
            f"{RAG_BATCH}, prompt {RAG_PROMPT}, {RAG_GEN} decode steps in "
            f"{m['serve_s']:.1f} s; peak memory {m['peak_memory_gb']:.1f} GB")
        log(f"[MoE {name}] TTFT mean {sm['ttft_avg_s'] * 1e3:.1f} ms, per "
            f"batch {[round(t * 1e3, 1) for t in m['ttft_s']]} ms; decode "
            f"{sm['decode_tps_avg']:.1f} tokens/s mean, per batch "
            f"{[round(t, 1) for t in m['decode_tps']]}; retrieval DAR "
            f"{sm['dar']:.4f}; {m['distinct_tokens']} distinct tokens")
        log(f"[MoE {name}] launches: {m['launches']}")
        log(f"[MoE {name}] decode window of {pr['steps']} steps: "
            f"{pr['wall_us_per_step']:.1f} us/step wall, device busy "
            f"{pr['device_busy_us_per_step']:.1f} us/step (profiler), idle "
            f"share {pr['device_idle_share']:.3f}, "
            f"{pr['launches_per_step']:.0f} kernel launches/step; "
            f"decode_attention {pr['decode_attention_us_per_step']:.1f} "
            f"us/step; top kernels us/step: "
            f"{json.dumps(pr['top_kernels_us_per_step'])}")
        log(f"[MoE {name}] one prefill (batch {RAG_BATCH} x {RAG_PROMPT}): "
            f"device busy {pp['device_busy_ms']:.1f} ms (profiler); top "
            f"kernels ms: {json.dumps(pp['top_kernels_ms'])}")
        drops = [sum(st) for st in rt["dropped_per_step"]]
        zeros = [sum(st) for st in rt["zeroed_per_step"]]
        log(f"[MoE {name}] routing at decode (batch 0, capacity "
            f"{rt['capacity']}, {rt['entries_per_layer_step']} entries a "
            f"layer): dropped (token, slot) pairs a step over the layers "
            f"min/mean/max {min(drops)}/{np.mean(drops):.2f}/{max(drops)}, "
            f"zeroed slot-0 tokens {min(zeros)}/{np.mean(zeros):.2f}/"
            f"{max(zeros)}; per step {drops}; zeroed {zeros}")
        log(f"[MoE {name}] layer 0, decode step 0 against a plain f32 loop "
            f"over each token's experts: max abs error {pl['max_abs_err']:.4g}"
            f" (tolerance {MOE_TOL}, |out| up to {pl['max_abs_out']:.3g}); "
            f"dropped {pl['dropped']}, zeroed {pl['zeroed_tokens']}, "
            f"capacity {pl['capacity']} equal to the layer's")
        log(f"[MoE {name}] replay of batch 0, backend=torch fed the "
            f"kernel run's tokens: {rp['rows_to_the_end']}/{RAG_BATCH} rows "
            f"compared to the end, {rp['positions_compared']} token "
            f"positions compared, {rp['tokens_equal']} equal, the rest "
            f"proven logit near-ties {json.dumps(rp['logit_near_ties'])}; "
            f"logits within {rp['max_logit_err']:.4g} (tolerance "
            f"{LOGIT_TOL}), router logits within "
            f"{rp['max_router_logit_err']:.3g} while the routing agreed "
            f"(near-tie tolerance {ROUTER_TOL}); rows ended: "
            f"{json.dumps(rp['ended'])}")


# ---------------------------------------------------------------------------
# Phase 3 (cont.): the cloud backends' new path shapes
# ---------------------------------------------------------------------------

def ivf_row(q, pr, vecs, ids, timer, scales=None, bias=None) -> dict:
    """Timing row of one ivf_scan shape (either mode): call, plain, library,
    bound and the kernel's device time (one launch a call)."""
    from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain

    b, d = q.shape
    cap = ids.shape[1]
    uniq = torch.unique(pr.long())
    valid = int((ids[uniq] >= 0).sum())
    per_vec = d * 4 if scales is None else d + 8
    n_bytes = q.numel() * 4 + pr.numel() * 4 + uniq.numel() * cap * 4 \
        + valid * per_vec + b * K * 8 + (0 if bias is None
                                         else bias.numel() * 4)
    bms, by = bound(n_bytes, 2 * b * pr.shape[1] * cap * d)

    def library():
        v = vecs[pr.long()].reshape(b, -1, d)
        s = torch.bmm(v if scales is None else v.float(), q[:, :, None])
        return torch.topk(s[..., 0], K)

    return {"ms": timer(lambda: ivf_scan(q, pr, vecs, ids, K, scales, bias)),
            "plain_ms": timer(lambda: ivf_scan_plain(q, pr, vecs, ids, K,
                                                     scales, bias), reps=10),
            "library_ms": timer(library, reps=10),
            "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                f"ivf_scan {tuple(vecs.shape)}",
                lambda: ivf_scan(q, pr, vecs, ids, K, scales, bias),
                IVF_KERNELS[0])}


def check_cloud_path_shapes(dev, timer, kres) -> None:
    """The shapes phase 9 gives the kernels: ``ivf_scan`` f32 and int8 at
    the scheduler's full batch (B=16) through ``IVFBackend`` (1024
    clusters, nprobe 32, cap 977) and over the rebuilt index (cap grown to
    REBUILT_CAP), and ``lexical_score`` over the grown postings (N =
    500,000 + the ingested docs) at B=16."""
    from repro_torch.kernels.lexical_score import (lexical_score,
                                                   lexical_score_plain)
    from repro_torch.retrieval.lexical import build_doc_terms, query_terms

    g = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    d, n_b, b = 768, 1024, REVAL_BATCH
    q = torch.randn(b, d, device=dev, generator=g)
    q /= q.norm(dim=-1, keepdim=True)
    pr = torch.stack([torch.randperm(n_b, device=dev, generator=g)[:32]
                      for _ in range(b)]).int()
    bias = torch.randn(b, 32, device=dev, generator=g) * 0.3
    for cap, tag in ((ANN_CAP, "IVFBackend"), (REBUILT_CAP, "rebuilt")):
        key = f"B={b},P=32,cap={cap} ({tag})"
        ids = torch.randperm(n_b * cap, device=dev, generator=g).int() \
            .reshape(n_b, cap)
        ids[torch.rand(n_b, cap, device=dev, generator=g) < 0.5] = -1
        vecs = torch.randn(n_b, cap, d, device=dev, generator=g)
        vecs /= vecs.norm(dim=-1, keepdim=True)
        vecs[ids < 0] = 0.0
        ivf_check(kres["ivf_scan"], key, q, pr, vecs, ids, K)
        kres["ivf_scan"][key] = ivf_row(q, pr, vecs, ids, timer)
        del vecs
        codes = torch.randint(-127, 128, (n_b, cap, d), dtype=torch.int8,
                              device=dev, generator=g)
        scales = torch.rand(n_b, cap, 2, device=dev, generator=g) * 1e-3 \
            + 1e-4
        ivf_check(kres["ivf_scan_int8"], key, q, pr, codes, ids, K, scales,
                  bias)
        kres["ivf_scan_int8"][key] = ivf_row(q, pr, codes, ids, timer,
                                             scales, bias)
        del codes, scales, ids
        torch.cuda.empty_cache()
    # the postings after phase 9's ingest: the world's 500,000 rows and the
    # ingested docs' rows (the flood's without terms)
    rec = kres["lexical_score"]
    n_ent, n_new = ENTITIES, INGEST_DOCS - INGEST_FLOOD
    doc_entity = np.concatenate([np.repeat(np.arange(n_ent), 5),
                                 rng.integers(0, n_ent, n_new)])
    attr_mask = np.zeros((len(doc_entity), 12), bool)
    for _ in range(4):
        attr_mask[np.arange(len(doc_entity)),
                  rng.integers(0, 12, len(doc_entity))] = True
    dt_np, dw_np = build_doc_terms(doc_entity, attr_mask, width=5)
    dt_np = np.concatenate([dt_np, np.full((INGEST_FLOOD, 5), -1,
                                           np.int32)])
    dw_np = np.concatenate([dw_np, np.zeros((INGEST_FLOOD, 5), np.float32)])
    dt, dw = (torch.as_tensor(a, device=dev) for a in (dt_np, dw_np))
    for b in (REVAL_BATCH,):
        qs = [query_terms(int(e), int(a)) for e, a in
              zip(rng.integers(0, n_ent, b), rng.integers(0, 12, b))]
        qt = torch.as_tensor(np.stack([t for t, _ in qs]), device=dev)
        qw = torch.as_tensor(np.stack([w for _, w in qs]), device=dev)
        key = f"B={b},N={dt.shape[0]} (after ingest)"
        kv, ki = lexical_score(qt, qw, dt, dw, K)
        pv, pi = lexical_score_plain(qt, qw, dt, dw, K)
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            raise AssertionError(f"lexical_score/{key}: kernel and plain "
                                 "differ (must be bit-equal)")
        hit_rows = int(torch.isin(dt, qt[qt >= 0]).any(dim=1).sum())
        n_bytes = dt.numel() * 4 + hit_rows * dt.shape[1] * 4 \
            + qt.numel() * 8 + b * K * 8
        bms, by = bound(n_bytes, dt.numel())
        rec["cases"][key] = {"max_abs_err": 0.0, "launches": 1}
        rec[key] = {
            "hit_rows": hit_rows,
            "ms": timer(lambda: lexical_score(qt, qw, dt, dw, K)),
            "plain_ms": timer(lambda: lexical_score_plain(qt, qw, dt, dw, K),
                              reps=10),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "kernel_device_us": one_launch_us(
                "lexical_score", lambda: lexical_score(qt, qw, dt, dw, K),
                LEXICAL_KERNEL)}
    del dt, dw
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 0: the world and the streams, against the reference's digests
# ---------------------------------------------------------------------------

def world_digests() -> tuple[dict, object]:
    """Digests of the quickstart twin's world and stream and of
    configuration 1's (whose world is returned for phases 4-9), held to
    the reference's pinned ones; a mismatch fails the run, after printing
    the keys that differ and where the installed numpy's own
    ``Generator.zipf`` parts from the port's sampler."""
    from repro_torch.data import digests
    from repro_torch.data.synthetic import SyntheticWorld, WorldConfig

    t0 = time.perf_counter()
    got = {"quickstart": digests.size_digests(SyntheticWorld, WorldConfig,
                                              "quickstart")}
    world = SyntheticWorld(WorldConfig(**digests.SIZES["config1"][0]))
    got["config1"] = digests.size_digests(SyntheticWorld, WorldConfig,
                                          "config1", world)
    out = {"numpy": np.__version__, "digests": got,
           "numpy_zipf_first_difference":
               digests.numpy_zipf_first_difference(),
           "mismatches": digests.mismatches(got, digests.PINNED),
           "s": time.perf_counter() - t0}
    log("world_digests " + json.dumps(out))
    if out["mismatches"]:
        raise AssertionError(
            f"world digests differ from the reference's: "
            f"{out['mismatches']}; numpy {np.__version__}'s own zipf parts "
            f"from the port's sampler at (index, numpy, port) "
            f"{out['numpy_zipf_first_difference']}")
    return out, world


# ---------------------------------------------------------------------------
# Phase 9: sharded, hybrid sharded, live ingest, replicas, agentic, the CLI
# ---------------------------------------------------------------------------

def sched_equal_hops(what, got, want) -> dict:
    """``sched_replay`` plus the hop graphs: hop identity, speculation,
    cancellations and each complex query's record equal."""
    out = sched_replay(what, got, want)
    for f in ("hop", "speculative"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{what} replay: {f} differs")
    try:
        np.testing.assert_equal(got.complex_records, want.complex_records)
    except AssertionError as e:
        raise AssertionError(f"{what} replay: complex records differ") from e
    out["cancelled"] = int(np.sum(got.channels == "cancelled"))
    return out


def sched_line(title, s) -> None:
    log(f"[{title}] modelled: DAR {s['dar']:.4f}, throughput "
        f"{s['throughput_qps']:.2f} qps, p50/p95/p99 "
        f"{s['p50_latency_s']:.1f} / {s['p95_latency_s']:.1f} / "
        f"{s['p99_latency_s']:.1f} s, full batches {s['full_batches']}, "
        f"channels {s['channels']}")


def sharded_path(dev, world, queries, service, index, counters) -> dict:
    """9a: ``ShardedMeshBackend`` (4 shards, 4 workers) against the flat
    scan on the 400-query stream, then the saturated scheduler over it
    with a ``backend="torch"`` replay."""
    from repro_torch.core.has import HasConfig
    from repro_torch.retrieval.service import (RetrievalService,
                                               ShardedMeshBackend)
    from repro_torch.serving.latency import LatencyModel
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)

    info = {}
    sharded = ShardedMeshBackend(service.corpus, K, LatencyModel(),
                                 n_shards=SHARDS, n_workers=SHARDS)
    q = torch.as_tensor(np.stack([x["emb"] for x in queries[:FULL_QUERIES]]),
                        device=dev)
    fs, fi = service.backend.search(q)
    ss, si = sharded.search(q)
    if not torch.equal(fi, si):
        bad = int((fi != si).any(1).nonzero()[0, 0])
        raise AssertionError(f"sharded: ids differ from flat at row {bad}")
    err = float_err(ss, fs, "sharded scores")
    if err > 1e-6:
        raise AssertionError(f"sharded: scores {err} from flat")
    info["vs_flat"] = {"rows": FULL_QUERIES, "ids_equal": True,
                       "max_abs_err": err}
    svc = RetrievalService(world, LatencyModel(), k=K, backend=sharded)
    # the cloud stage alone, one full_search a fresh query: sharded, flat
    window = world.sample_queries(PROFILE_STEPS, **stream_kw(), seed=2)
    info["profile_cloud"] = profile_window(
        lambda q: (svc.full_search(q["emb"]), False), window)
    info["profile_cloud_flat"] = profile_window(
        lambda q: (service.full_search(q["emb"]), False), window)
    cfg = HasConfig(k=K, tau=TAU, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)

    def make(**kw):
        return ContinuousBatchingScheduler(
            svc, cfg, SchedulerConfig(**SCHED_KW, **kw), index=index)

    sched = make()
    res, wall, launches = sched_timed(counters, sched, queries, None, seed=0)
    info["saturated"] = {"serve_s": wall, "launches": launches,
                         "n_full_workers": sched.n_full_workers,
                         "summary": sched_summary(res),
                         "spans_s": {s: float(v.sum()) for s, v in
                                     res.trace.spans.items()},
                         **sched_checks("sharded", sched, res, len(queries))}
    if res.max_inflight_full_batches < 2:
        raise AssertionError("sharded: the worker pool never overlapped")
    res_t, wall_t, _ = sched_timed(counters, make(backend="torch"), queries,
                                   None, seed=0)
    info["saturated"]["replay"] = sched_replay("sharded", res_t, res)
    info["saturated"]["replay"]["serve_s"] = wall_t
    return info


def hybrid_sharded_path(dev, world, queries, index, counters) -> dict:
    """9b: ``HybridBackend(dense="sharded")`` under the full engine and
    ``HasEngine(fusion="rrf")``, and a ``backend="torch"`` replay."""
    from repro_torch.core.has import HasConfig
    from repro_torch.retrieval.fusion import _fuse_tail
    from repro_torch.retrieval.service import HybridBackend, RetrievalService
    from repro_torch.serving.engine import FullRetrievalEngine, HasEngine
    from repro_torch.serving.latency import LatencyModel

    info = {}
    kw = dict(HYBRID, dense="sharded", n_shards=SHARDS)
    kw.pop("ann_kwargs")
    hybrid = HybridBackend(world.doc_emb, K, LatencyModel(), world.doc_terms,
                           world.doc_term_weights, **kw)
    service = RetrievalService(world, LatencyModel(), k=K, backend=hybrid)
    cfg = HasConfig(k=K, tau=TAU, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768, fusion="rrf")
    qs = queries[:FULL_QUERIES]
    counters.reset()
    t0 = time.perf_counter()
    full = FullRetrievalEngine(service).serve(qs)
    has = HasEngine(service, cfg, index=index)
    steps = recording(has)
    res = has.serve(qs)
    info["serve_s"] = time.perf_counter() - t0
    info["launches"] = counters.read()
    info["full"], info["has"] = full.summary(), res.summary()
    check_steps("hybrid sharded", steps, info["has"])
    window = world.sample_queries(PROFILE_STEPS, **stream_kw(), seed=2)
    info["profile_cloud"] = profile_window(
        lambda q: (service.full_search(q["emb"], q["terms"],
                                       q["term_weights"]), False), window)
    plain = copy.copy(hybrid)
    plain.backend = "torch"
    replay = HasEngine(RetrievalService(world, LatencyModel(), k=K,
                                        backend=plain),
                       cfg, backend="torch", index=index)
    plain_steps = recording(replay)
    replay.serve(qs[:REPLAY_QUERIES])
    swaps = 0
    for i, (a, b) in enumerate(zip(steps, plain_steps)):
        if a[1] != b[1]:
            raise AssertionError(f"hybrid sharded replay: accept differs at "
                                 f"query {i}")
        if not (a[0] != b[0]).any():
            continue
        if a[1] and dense_near_tie(service, qs[i]["emb"], a[0], b[0]):
            swaps += int((a[0] != b[0]).sum())
            continue
        raise AssertionError(f"hybrid sharded replay: ids differ at query "
                             f"{i}")
    # the fusion tail alone, on one dense list, kernels against plain
    q = torch.as_tensor(np.stack([x["emb"] for x in qs[:64]]), device=dev)
    qt = torch.as_tensor(np.stack([x["terms"] for x in qs[:64]]),
                         device=dev).int()
    qw = torch.as_tensor(np.stack([x["term_weights"] for x in qs[:64]]),
                         device=dev).float()
    from repro_torch.retrieval.distributed import sharded_topk_reference
    _, i_d = sharded_topk_reference(hybrid.corpus, q, hybrid.dense_k,
                                    n_shards=SHARDS)
    tails = [_fuse_tail(hybrid.corpus, q, i_d, qt, qw, hybrid._terms,
                        hybrid._tw, k=K, kl=hybrid.lexical_k,
                        rrf_k=hybrid.rrf_k,
                        diversify_sim=hybrid.diversify_sim, backend=be,
                        tile_n=hybrid.tile_n)[1] for be in (None, "torch")]
    if not torch.equal(*tails):
        raise AssertionError("hybrid sharded: lexical + fusion differ on "
                             "the same dense list")
    info["replay"] = {"queries": len(plain_steps), "accept_equal": True,
                      "ids_equal_except_draft_near_ties": swaps}
    return info


def new_passages(world, n, rng):
    """``n`` passages of existing entities, made with the world's recipe
    (entity vector, the mix of 4 of its attributes, unit noise), their
    postings rows, entities and attribute masks."""
    from repro_torch.retrieval.lexical import build_doc_terms

    cfg = world.cfg

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-8)

    ent = rng.integers(0, cfg.n_entities, n)
    sel = rng.random((n, cfg.attrs_per_entity)).argsort(axis=1)
    sel = sel[:, :cfg.attrs_per_doc]
    mask = np.zeros((n, cfg.attrs_per_entity), bool)
    np.put_along_axis(mask, sel, True, axis=1)
    mix = world.attr_basis[sel].sum(axis=1) / np.sqrt(cfg.attrs_per_doc)
    emb = (cfg.entity_weight * world.entity_vecs[ent]
           + cfg.attr_weight_doc * mix
           + cfg.noise_doc * unit(rng.normal(size=(n, cfg.d))))
    terms, weights = build_doc_terms(ent, mask,
                                     width=world.doc_terms.shape[1])
    return unit(emb).astype(np.float32), terms, weights, ent, mask


def flood_near(centroid, n, rng):
    x = centroid[None] + 0.01 * rng.normal(size=(n, len(centroid)))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def ivf_backend_score_of(be, q):
    """score_of(row, id) of an ``IVFBackend`` search, recomputed from its
    host arrays: the bucket slot's f32 or int8 score (centroid term from
    the probe product), or the residual row's f32 score."""
    from repro_torch.utils import stable_topk

    qh = q.cpu().double().numpy()
    cvals, probe = stable_topk(q @ be.index.centroids.T, be.nprobe)
    cvals, probe = cvals.cpu().numpy(), probe.cpu().numpy()
    h = q.shape[1] // 2

    def score_of(r, gid):
        res = np.flatnonzero(be._res_ids_np[:be.residual_count] == gid)
        if len(res):
            return float(qh[r] @ be._res_vecs_np[res[0]])
        c, s = (int(x[0]) for x in np.nonzero(be._bids_np == gid))
        at = np.flatnonzero(probe[r] == c)
        if not len(at):
            return -float("inf")
        v = be._bvecs_np[c, s].astype(np.float64)
        if not be.compressed:
            return float(qh[r] @ v)
        sc = be._bscales_np[c, s]
        return float((qh[r, :h] @ v[:h]) * sc[0] + (qh[r, h:] @ v[h:])
                     * sc[1] + cvals[r, at[0]])

    return score_of


def ingest_round(be, q, counters) -> dict:
    """``be.search`` with the kernels against ``backend="torch"`` on the
    same index, in batches of REVAL_BATCH (the scheduler's full batch):
    scores within SCORE_TOL, ids equal except proven near-ties.  Also the
    kernels' launches of these searches."""
    errs, swaps = [], 0
    before = counters.read()
    for lo in range(0, q.shape[0], REVAL_BATCH):
        qb = q[lo:lo + REVAL_BATCH]
        kv, ki = be.search(qb)
        after = counters.read()
        be.backend = "torch"
        try:
            pv, pi = be.search(qb)
        finally:
            be.backend = None
        e, sw = compare_topk("ingest replay", kv, ki, pv, pi,
                             ivf_backend_score_of(be, qb))
        errs.append(e)
        swaps += sw
    return {"queries": int(q.shape[0]), "max_abs_err": max(errs),
            "near_tie_swaps": swaps,
            "launches": {n: after[n] - before[n] for n in after}}


def found_by_own_embedding(be, vecs, ids) -> dict:
    """Each ingested doc that the index holds (a bucket or the residual)
    is in the top-k of its own embedding.  Before a rebuild the index
    holds every one (a bucket or the residual); a rebuild cuts the docs of
    buckets past their capacity, as the reference's build does."""
    dev = be.corpus.device
    held = np.isin(ids, be._bids_np) | np.isin(
        ids, be._res_ids_np[:be.residual_count])
    missed = 0
    for lo in range(0, len(ids), 512):
        _, got = be.search(torch.as_tensor(vecs[lo:lo + 512], device=dev))
        got = got.cpu().numpy()
        for j, gid in enumerate(ids[lo:lo + 512]):
            if held[lo + j] and gid not in got[j]:
                missed += 1
    if missed:
        raise AssertionError(f"ingest: {missed} held docs not found by "
                             "their own embedding")
    return {"docs": int(len(ids)), "held": int(held.sum()), "found": True}


def hybrid_round(be, q, qt, qw, counters) -> dict:
    """The hybrid stage's search with the kernels against
    ``backend="torch"``, in batches of REVAL_BATCH: ids equal, except rows
    where the int8 dense channel swapped near-tied candidates and the
    lexical + fusion tail then agrees on the same dense list."""
    from repro_torch.retrieval.fusion import _fuse_tail, ivf_ann_body

    swaps, before = 0, counters.read()
    for lo in range(0, q.shape[0], REVAL_BATCH):
        args = [a[lo:lo + REVAL_BATCH] for a in (q, qt, qw)]
        got = be.search(*args)
        after = counters.read()
        be.backend = "torch"
        try:
            want = be.search(*args)
        finally:
            be.backend = None
        for r in (got[1] != want[1]).any(1).nonzero()[:, 0].tolist():
            qr, tr, wr = (a[r:r + 1] for a in args)
            dense = [ivf_ann_body(be._ivf.index, be._ivf._res_vecs,
                                  be._ivf._res_ids, qr, nprobe=be._ivf.nprobe,
                                  k=be.dense_k, backend=x)
                     for x in (None, "torch")]
            _, sw = compare_topk("hybrid ingest dense channel", *dense[0],
                                 *dense[1], ivf_backend_score_of(be._ivf, qr))
            tails = [_fuse_tail(be.corpus, qr, dense[1][1], tr, wr,
                                be._terms, be._tw, k=be.k, kl=be.lexical_k,
                                rrf_k=be.rrf_k,
                                diversify_sim=be.diversify_sim, backend=x,
                                tile_n=be.tile_n)[1] for x in (None, "torch")]
            if not sw or not torch.equal(*tails):
                raise AssertionError(f"hybrid ingest: ids differ at query "
                                     f"{lo + r}, not by a near-tie")
            swaps += sw
    return {"queries": int(q.shape[0]), "near_tie_swaps": swaps,
            "launches": {n: after[n] - before[n] for n in after}}


def ingest_path(dev, world, queries, counters) -> dict:
    """9c: live ingest into ``IVFBackend`` (f32 and int8, the serve
    defaults: 1024 clusters, nprobe 32, residual_cap 1024) and into
    ``HybridBackend(dense="ann")`` with terms.  After each batch: 64
    queries (half the stream's, half asking the new docs' entities) with
    the kernels against ``backend="torch"``; at the end, every ingested
    doc the index holds is found by its own embedding."""
    import gc

    from repro_torch.retrieval.service import HybridBackend, IVFBackend
    from repro_torch.serving.latency import LatencyModel

    info = {}
    rng_q = np.random.default_rng(12)
    half = INGEST_QUERIES // 2
    stream = queries[:half]

    def probe_queries(ent, mask):
        picks = rng_q.choice(len(ent), half, replace=len(ent) < half)
        asked = [(int(ent[i]), int(np.flatnonzero(mask[i])[0]))
                 for i in picks]
        embs = [x["emb"] for x in stream] + [
            world.encode_query(e, a, rng_q) for e, a in asked]
        from repro_torch.retrieval.lexical import query_terms
        terms = [query_terms(x["entity"], x["attr"]) for x in stream] + [
            query_terms(e, a) for e, a in asked]
        return (torch.as_tensor(np.stack(embs), device=dev),
                torch.as_tensor(np.stack([t for t, _ in terms]),
                                device=dev).int(),
                torch.as_tensor(np.stack([w for _, w in terms]),
                                device=dev).float())

    def run_batches(be, dense, ingest, check, name):
        rng = np.random.default_rng(21)
        rec = {"rounds": []}
        vecs_all, ids_all = [], []
        one = new_passages(world, 1, rng)
        new = new_passages(world, INGEST_NEW, rng)
        # one doc twice under one key, the new passages, then the flood
        for i, (key, batch) in enumerate((("one", one), ("one", one),
                                          ("new", new), ("flood", None))):
            if key == "flood":                    # near the current c0
                batch = (flood_near(dense._cents_np[0].copy(), INGEST_FLOOD,
                                    rng), None, None, new[3], new[4])
            rows0 = be._corpus_np.shape[0]
            ids = np.asarray(ingest(be, batch, key))
            if i == 1:                            # the repeated key
                if be._corpus_np.shape[0] != rows0 or \
                        not np.array_equal(ids, ids_all[0]):
                    raise AssertionError(f"ingest {name}: a repeated "
                                         "ingest_key grew the corpus")
            else:
                vecs_all.append(batch[0])
                ids_all.append(ids)
            rnd = {"batch": key, "docs": int(len(ids)),
                   "residual_count": dense.residual_count,
                   "rebuilds": dense.rebuilds,
                   "capacity": int(dense._bids_np.shape[1]),
                   **check(be, probe_queries(*batch[3:5])),
                   "found": found_by_own_embedding(
                       dense, np.concatenate(vecs_all),
                       np.concatenate(ids_all))}
            rec["rounds"].append(rnd)
            log(f"[ingest {name}] after '{key}' ({len(ids)} docs): "
                f"residual_count {dense.residual_count}, rebuilds "
                f"{dense.rebuilds}, cap {dense._bids_np.shape[1]}; "
                f"{rnd['queries']} queries in batches of {REVAL_BATCH}, "
                f"kernels = torch (near-tie swaps {rnd['near_tie_swaps']}); "
                f"{rnd['found']['held']} of {rnd['found']['docs']} ingested "
                f"docs held, each found by its own embedding")
        if dense.rebuilds < 1:
            raise AssertionError(f"ingest {name}: the flood did not "
                                 "overflow the residual")
        if dense.index.capacity != REBUILT_CAP:
            raise AssertionError(f"ingest {name}: rebuilt cap "
                                 f"{dense.index.capacity} != {REBUILT_CAP}")
        if any(r["found"]["held"] != r["found"]["docs"]
               for r in rec["rounds"] if not r["rebuilds"]):
            raise AssertionError(f"ingest {name}: a doc was lost before "
                                 "any rebuild")
        rec["found"] = rec["rounds"][-1]["found"]
        return rec

    for compressed in (False, True):
        name = "ivf_int8" if compressed else "ivf_f32"
        counters.reset()
        t0 = time.perf_counter()
        be = IVFBackend(world.doc_emb, K, LatencyModel(),
                        compressed=compressed, n_workers=2, device=dev,
                        **ANN_INGEST)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cap0 = be.index.capacity
        rec = run_batches(
            be, be, lambda b, batch, key: b.ingest_docs(batch[0],
                                                        ingest_key=key),
            lambda b, qs: ingest_round(b, qs[0], counters), name)
        rec.update(build_s=build_s, capacity_first=cap0,
                   launches=counters.read())
        info[name] = rec
        del be
        gc.collect()
        torch.cuda.empty_cache()

    counters.reset()
    hybrid = HybridBackend(world.doc_emb, K, LatencyModel(), world.doc_terms,
                           world.doc_term_weights, **HYBRID)

    def h_ingest(be, batch, key):
        n0 = be._corpus_np.shape[0]
        ids = None if key == "one" else np.arange(n0, n0 + len(batch[0]))
        return be.ingest_docs(batch[0], ids, terms=batch[1],
                              term_weights=batch[2], ingest_key=key)

    rec = run_batches(hybrid, hybrid._ivf, h_ingest,
                      lambda b, qs: hybrid_round(b, *qs, counters),
                      "hybrid ann")
    if hybrid.corpus.shape[0] != world.cfg.n_docs + INGEST_DOCS or \
            hybrid._terms.shape[0] != hybrid.corpus.shape[0]:
        raise AssertionError("hybrid ingest: the channels did not grow in "
                             "lockstep")
    rec["launches"] = counters.read()
    rec["postings_rows"] = int(hybrid._terms.shape[0])
    info["hybrid_ann"] = rec
    del hybrid
    gc.collect()
    torch.cuda.empty_cache()
    return info


def replica_path(dev, world, queries, service, index, counters) -> dict:
    """9d: ``serve --retrieval-backend replica``: ``ReplicaBackend`` over
    the flat scan with two warm standbys, under the saturated scheduler;
    every folded row in each standby's log once, and a failover that
    resumes with the primary's rings and pointers exactly."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.has import HasConfig
    from repro_torch.retrieval.service import (LocalFlatBackend,
                                               ReplicaBackend,
                                               RetrievalService)
    from repro_torch.serving.latency import LatencyModel
    from repro_torch.serving.replication import WarmStandby
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)

    cfg = HasConfig(k=K, tau=TAU, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        standbys = [WarmStandby(cfg, CheckpointManager(f"{tmp}/standby{i}"),
                                snapshot_every=10_000, max_lag=50_000)
                    for i in range(2)]
        lat = LatencyModel()
        backend = ReplicaBackend(LocalFlatBackend(service.corpus, K, lat),
                                 standbys, service.corpus)
        svc = RetrievalService(world, lat, k=K, backend=backend)
        sched = ContinuousBatchingScheduler(svc, cfg,
                                           SchedulerConfig(**SCHED_KW),
                                           index=index)
        res, wall, launches = sched_timed(counters, sched, queries, None,
                                          seed=0)
        info = {"serve_s": wall, "launches": launches,
                "n_full_workers": sched.n_full_workers,
                "summary": sched_summary(res),
                **sched_checks("replica", sched, res, len(queries))}
        folded = info["folded_rows"]
        fields = [f.name for f in dataclasses.fields(sched.state)]
        for i, sb in enumerate(standbys):
            rows = [q.tobytes() for q, _, _ in sb.log]
            if sb._step != folded or len(rows) != folded or \
                    len(set(rows)) != folded:
                raise AssertionError(
                    f"replica: standby {i} logged {len(rows)} rows "
                    f"({len(set(rows))} distinct, step {sb._step}) for "
                    f"{folded} folded")
            rec = sb.failover()
            for f in fields:
                if not torch.equal(getattr(rec, f), getattr(sched.state, f)):
                    raise AssertionError(f"replica: standby {i} failover "
                                         f"{f} differs from the primary")
        info["standbys"] = {"count": len(standbys), "rows_each": folded,
                            "failover_exact": True}
    return info


def agentic_path(dev, world, service, index, counters) -> dict:
    """9e: ``TwoHopDataset`` complex queries, the sequential
    ``AutoRagPipeline`` (full against HaS) and the scheduler with
    ``speculate_hops`` on and off (Poisson at 0.35x the edge rate), each
    with a ``backend="torch"`` replay."""
    from repro_torch.core.has import HasConfig
    from repro_torch.serving.agentic import AutoRagPipeline, TwoHopDataset
    from repro_torch.serving.engine import HasEngine
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig,
                                               poisson_arrivals)

    info = {}
    cfg = HasConfig(k=K, tau=TAU, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)
    ds = TwoHopDataset(world, seed=0)
    cqs = ds.sample(AGENTIC_QUERIES, seed=2)
    counters.reset()
    t0 = time.perf_counter()
    base = AutoRagPipeline(ds, None, service).run(cqs)
    has = HasEngine(service, cfg, index=index)
    steps = recording(has)
    plug = AutoRagPipeline(ds, has, service).run(cqs)
    info["seq_s"] = time.perf_counter() - t0
    info["seq_launches"] = counters.read()
    replay = HasEngine(service, cfg, backend="torch", index=index)
    plain_steps = recording(replay)
    plug_t = AutoRagPipeline(ds, replay, service).run(cqs)
    swaps = 0
    for i, (a, b) in enumerate(zip(steps, plain_steps)):
        if a[1] != b[1]:
            raise AssertionError(f"agentic sequential replay: accept "
                                 f"differs at step {i}")
        if (a[0] != b[0]).any():
            swaps += int((a[0] != b[0]).sum())
    if (plug_t["dar"], plug_t["accuracy"]) != (plug["dar"],
                                               plug["accuracy"]):
        raise AssertionError("agentic sequential replay: DAR or accuracy "
                             "differ")
    cut = (plug["retrieval_latency"] - base["retrieval_latency"]) \
        / base["retrieval_latency"]
    info["sequential"] = {"full": base, "has": plug, "retrieval_cut": cut,
                          "replay": {"steps": len(plain_steps),
                                     "accept_equal": True,
                                     "id_differences": swaps}}
    probe = ContinuousBatchingScheduler(service, cfg, SchedulerConfig(),
                                        index=index)
    qps = 0.35 * probe.sched.max_spec_batch / probe._spec_time(
        probe.sched.max_spec_batch)
    arrivals = poisson_arrivals(AGENTIC_QUERIES, qps=qps, seed=11)
    info["qps"] = qps
    for speculate in (True, False):
        arm = {}
        for be in (None, "torch"):
            eng = ContinuousBatchingScheduler(
                service, cfg, SchedulerConfig(speculate_hops=speculate,
                                              backend=be), index=index)
            torch.cuda.synchronize()
            counters.reset()
            t0 = time.perf_counter()
            out = AutoRagPipeline(ds, eng, service).run(cqs,
                                                        arrivals=arrivals)
            torch.cuda.synchronize()
            arm[be] = (out, time.perf_counter() - t0, counters.read())
        (out, wall, launches), (out_t, wall_t, _) = arm[None], arm["torch"]
        t_res = out_t.pop("sched_result")
        res = out.pop("sched_result")
        n = len(res.channels)
        resid = float(np.abs(res.trace.conservation_residual()).max())
        if resid > 1e-9 or (res.t_done < 0).any():
            raise AssertionError(f"agentic scheduler: spans {resid}")
        key = "pipelined" if speculate else "sequential_hops"
        info[key] = {"summary": out, "serve_s": wall, "launches": launches,
                     "requests": n, "conservation_residual_max": resid,
                     "sched": sched_summary(res),
                     "replay": sched_equal_hops(f"agentic {key}", t_res,
                                                res)}
        info[key]["replay"]["serve_s"] = wall_t
        np.testing.assert_equal(out_t, out)
    return info


def cli_path(counters) -> dict:
    """9f: ``repro_torch.launch.serve.main`` with the scheduler and agentic
    traffic for each cloud backend, and two invalid flag sets (exit 2)."""
    import contextlib
    import io

    from repro_torch.launch import serve

    info = {}
    base = ["--engine", "sched", "--agentic-frac", "0.25", "--queries",
            str(CLI_QUERIES)]
    for name, extra in CLI_BACKENDS.items():
        buf = io.StringIO()
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = serve.main(base + extra)
        torch.cuda.synchronize()
        s = res.summary()
        if len(res.channels) < CLI_QUERIES or s["complex_n"] != \
                round(0.25 * CLI_QUERIES):
            raise AssertionError(f"serve {name}: {s}")
        info[name] = {"s": time.perf_counter() - t0,
                      "launches": counters.read(),
                      "dar": s["dar"], "complex_n": s["complex_n"],
                      "complex_dar": s["complex_dar"],
                      "header": buf.getvalue().splitlines()[0]}
    for bad in CLI_INVALID:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                serve.main(bad)
            except SystemExit as e:
                code = e.code
            else:
                code = 0
        if code != 2:
            raise AssertionError(f"serve {bad}: exit {code}, want 2")
        info[" ".join(bad)] = {"exit": code,
                               "error": err.getvalue().strip()
                               .splitlines()[-1]}
    return info


def phase9_launches(p9) -> dict[str, int]:
    """Each kernel's launches summed over phase 9's paths, each read with
    the counts set to 0 just before it."""
    runs = [p9["sharded"]["saturated"]["launches"],
            p9["hybrid_sharded"]["launches"],
            p9["replica"]["launches"],
            p9["agentic"]["seq_launches"],
            p9["agentic"]["pipelined"]["launches"],
            p9["agentic"]["sequential_hops"]["launches"]]
    runs += [r["launches"] for r in p9["ingest"].values()]
    runs += [r["launches"] for r in p9["cli"].values() if "launches" in r]
    return {n: sum(r[n] for r in runs) for n in runs[0]}


def report_phase9(p9) -> None:
    """Phase 9's lines of the log."""
    def window(title, pr):
        log(f"[{title}] cloud stage alone, {pr['steps']} fresh queries: "
            f"{pr['wall_us_per_step']:.1f} us/step wall, device busy "
            f"{pr['device_busy_us_per_step']:.1f} us/step (profiler), "
            f"{pr['device_ops_per_step']:.1f} device ops/step, idle share "
            f"{pr['device_idle_share']:.3f}; top kernels us/step: "
            f"{json.dumps(pr['top_kernels_us_per_step'])}")

    sh = p9["sharded"]
    log(f"[9a sharded] {SHARDS} shards vs flat on {FULL_QUERIES} queries: "
        f"ids equal in every row, scores within "
        f"{sh['vs_flat']['max_abs_err']:.3g}")
    window("9a sharded", sh["profile_cloud"])
    window("9a flat, the same window", sh["profile_cloud_flat"])
    sat = sh["saturated"]
    sched_line("9a sharded scheduler, saturated", sat["summary"])
    log(f"[9a sharded scheduler] {sat['n_full_workers']} workers, serve "
        f"{sat['serve_s']:.2f} s wall; spans (virtual s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sat["spans_s"].items())
        + f"; torch replay equal ({sat['replay']['serve_s']:.2f} s); "
        f"launches {sat['launches']}")
    hs = p9["hybrid_sharded"]
    log(f"[9b hybrid sharded] full DocHit {hs['full']['doc_hit_rate']:.4f}; "
        f"HaS(rrf) DAR {hs['has']['dar']:.4f}, DocHit "
        f"{hs['has']['doc_hit_rate']:.4f}; {hs['serve_s']:.1f} s; replay of "
        f"{hs['replay']['queries']}: accept bits and ids equal (draft "
        f"near-tie swaps {hs['replay']['ids_equal_except_draft_near_ties']})"
        f"; launches {hs['launches']}")
    window("9b hybrid sharded", hs["profile_cloud"])
    for name, r in p9["ingest"].items():
        log(f"[9c ingest {name}] every held doc found by its own embedding "
            f"({r['found']['held']} of {r['found']['docs']} held); "
            f"launches {r['launches']}")
    rp = p9["replica"]
    sched_line("9d replica scheduler, saturated", rp["summary"])
    log(f"[9d replica] {rp['standbys']['count']} standbys, each logged "
        f"{rp['standbys']['rows_each']} rows once; failover equal to the "
        f"primary's rings and pointers; launches {rp['launches']}")
    ag = p9["agentic"]
    sq = ag["sequential"]
    log(f"[9e agentic sequential] {AGENTIC_QUERIES} complex queries: full "
        f"retrieval {sq['full']['retrieval_latency']:.3f} s, accuracy "
        f"{sq['full']['accuracy']:.4f}; HaS retrieval "
        f"{sq['has']['retrieval_latency']:.3f} s, DAR {sq['has']['dar']:.4f}"
        f", accuracy {sq['has']['accuracy']:.4f}; retrieval-latency cut "
        f"{sq['retrieval_cut']:+.2%}; torch replay equal in accepts, DAR "
        f"and accuracy ({sq['replay']['id_differences']} ids differ)")
    for key in ("sequential_hops", "pipelined"):
        r = ag[key]
        s = r["summary"]
        log(f"[9e agentic scheduler, {key}] {ag['qps']:.3f} qps Poisson: "
            f"complex e2e {s['e2e_latency']:.3f} s, retrieval "
            f"{s['retrieval_latency']:.3f} s, DAR {s['dar']:.4f}, accuracy "
            f"{s['accuracy']:.4f}, prespec {s['hop2_prespec_rate']:.3f} "
            f"(hit {s['hop2_prespec_hit_rate']:.3f}), cancelled "
            f"{r['replay']['cancelled']} of {r['requests']} requests; serve "
            f"{r['serve_s']:.2f} s; torch replay equal")
    for name, r in p9["cli"].items():
        if "exit" in r:
            log(f"[9f serve {name}] exit {r['exit']}: {r['error']}")
        else:
            log(f"[9f serve {name}] {r['header']}; DAR {r['dar']:.4f}, "
                f"complex {r['complex_n']:.0f} (DAR "
                f"{r['complex_dar']:.4f}), {r['s']:.1f} s")
    log(f"[phase 9] {p9['phase_s']:.1f} s; launches {p9['launches']}")


# ---------------------------------------------------------------------------
# Phase 10: the LM training path
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 x the parameters a token touches
    (the embedding's gather excluded) x tokens, plus 12 x layers x seq x
    heads x d_head x tokens for the S x S scores and their products (the
    port computes the full square; remat's recompute is not counted)."""
    n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    return tokens * (6 * n + 12 * cfg.n_layers * seq * cfg.n_heads
                     * cfg.d_head)


def lm_batch(vocab: int, n: int, seq: int, dev) -> dict:
    """Tokens and labels drawn as ``lm_smoke`` draws them (numpy,
    ``default_rng(0)``), int32 on the card."""
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.integers(0, vocab, (n, seq)),
                               dtype=torch.int32, device=dev)
            for k in ("tokens", "labels")}


def loss_and_grads(params, cfg, batch, compute_dtype):
    """The transformer's loss and the gradients of every master leaf."""
    import functools

    from repro_torch.models import transformer as tf
    return loss_grads(functools.partial(tf.loss_fn, cfg=cfg,
                                        compute_dtype=compute_dtype),
                      params, batch)


def loss_grads(loss_fn, params, batch) -> tuple:
    """The loss and every parameter leaf's gradient (a list; zeros where
    the loss does not reach a leaf), one forward and backward; the
    parameters are released after."""
    from repro_torch.training.optimizer import leaves
    ps = [t for _, parts in leaves(params) for t in parts]
    for t in ps:
        t.requires_grad_(True)
    loss, _ = loss_fn(params, batch)
    loss.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in ps]
    for t in ps:
        t.grad = None
        t.requires_grad_(False)
    return loss.detach(), grads


def rel_err(got: list, want: list) -> float:
    """The largest ``max|got - want| / max|want|`` over the leaves."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def peak_gb(fn) -> float:
    """Peak memory (GB) above what was allocated before ``fn``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def step_memory(*args) -> dict:
    """Before a step's peak is measured: the bytes of its arguments and
    of everything allocated (the baseline), then the peak stats reset.
    The step's own peak is ``args + max_memory_allocated - baseline``
    (phase 12a holds the dry run's prediction to it)."""
    torch.cuda.synchronize()
    out = {"step_args_bytes": tree_bytes(args),
           "step_baseline_bytes": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    return out


def timed_steps(step, params, state, batch, n: int) -> tuple[list, list]:
    """``n`` steps on the host clock (each ending in a synchronize) ->
    (seconds, metrics with floats)."""
    times, metrics = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics


def step_profile(step, params, state, batch, wall_s: float) -> dict:
    """One step under the profiler: device busy (the kernels' sum), idle
    share against ``wall_s`` (an unprofiled step's), launches, top
    kernels."""
    counts = {}
    times = device_times(lambda: step(params, state, batch), 1, warm=False,
                         counts=counts)
    busy_ms = sum(times.values()) / 1e3

    def ms(pred):
        return sum(v for k, v in times.items() if pred(k)) / 1e3

    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "launches": sum(counts.values()),
            # cuBLAS's products (nvjet, gemm and cutlass kernels) and the
            # softmax; the rest is elementwise work, copies and reductions
            "matmul_ms": ms(lambda k: "nvjet" in k or "gemm" in k.lower()
                            or "cutlass" in k),
            "softmax_ms": ms(lambda k: "SoftMax" in k),
            "top_kernels_ms": top_ops(times, 8, 1e3)}


def optimizer_ms(opt_cfg, params, state, update) -> dict:
    """The optimizer part of a step, timed alone (CUDA events, median of
    3 after a warm-up) on gradients of the parameters' shapes and dtypes:
    the global norm, the clip and ``update`` (AdamW or Adafactor, in
    place), then ``update`` alone."""
    from repro_torch.training import optimizer as opt
    grads = tree_map(lambda t: torch.full_like(t, 1e-4), params)

    def run(clip):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        if clip:
            opt.opt_update(opt_cfg, grads, state, params,
                           grad_norm=opt.global_norm(grads))
        else:
            update(opt_cfg, grads, state, params)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    out = {}
    for key, clip in (("with_norm_and_clip_ms", True), ("update_ms", False)):
        run(clip)
        out[key] = statistics.median(run(clip) for _ in range(3))
    return out


STEP_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) grad_norm "
                       r"(\S+) (\d+) ms")


def run_captured(fn, *a, **kw):
    """``fn``'s result and its printed lines (kept out of this log)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


def train_entry_point(dev) -> dict:
    """10a: ``launch.train.main`` on the lm100m preset for TRAIN_STEPS
    steps with checkpoints, then TRAIN_RESUME more steps resumed from the
    last; both against one uninterrupted run of all the steps."""
    import tempfile

    from repro_torch.data import digests
    from repro_torch.data.lm import MarkovLM
    from repro_torch.launch import train

    got = {size: digests.markov_digests(MarkovLM, size)
           for size in digests.MARKOV_SIZES}
    bad = digests.mismatches(got, digests.MARKOV_PINNED)
    if bad:
        raise AssertionError(f"MarkovLM digests differ from the "
                             f"reference's (numpy {np.__version__}): {bad}")
    log(f"[10a train] MarkovLM digests (table and first batch, "
        f"{sorted(digests.MARKOV_SIZES)}) equal the reference's, numpy "
        f"{np.__version__}")
    n, extra = TRAIN_STEPS, TRAIN_RESUME
    cfg = train.make_lm100m()
    info = {"params": cfg.param_count(), "steps": n, "resumed_steps": extra}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as ck:
        t0 = time.perf_counter()
        first, lines = run_captured(train.main, [
            "--preset", "lm100m", "--steps", str(n), "--ckpt-dir", ck])
        info["first_s"] = time.perf_counter() - t0
        resumed, lines_r = run_captured(train.main, [
            "--preset", "lm100m", "--steps", str(n + extra), "--ckpt-dir",
            ck])
    whole, lines_w = run_captured(train.train_lm, cfg, n + extra, 8, 128,
                                  None)
    if f"[train] resumed from step {n}" not in lines_r:
        raise AssertionError(f"lm100m: no resume from step {n}: "
                             f"{lines_r[:3]}")
    if len(first) != n or len(resumed) != extra or \
            not np.isfinite(whole).all() or not np.isfinite(first).all():
        raise AssertionError("lm100m: malformed losses")
    head, tail = np.mean(first[:10]), np.mean(first[-10:])
    if not (tail < head and first[-1] < first[0]):
        raise AssertionError(f"lm100m: the loss did not fall ({head} -> "
                             f"{tail})")
    info["resume_err"] = float(np.abs(np.subtract(resumed,
                                                  whole[n:])).max())
    info["first_err"] = float(np.abs(np.subtract(first, whole[:n])).max())
    if max(info["resume_err"], info["first_err"]) > RESUME_TOL:
        raise AssertionError(f"lm100m: resumed losses {info['resume_err']}"
                             f", first run {info['first_err']} from the "
                             f"uninterrupted run's (tolerance {RESUME_TOL})")
    ms = [float(m.group(4)) for m in map(STEP_LINE.match, lines_w)
          if m and int(m.group(1)) > 0]
    info.update(loss_first=first[0], loss_last=first[-1],
                loss_mean_first10=head, loss_mean_last10=tail,
                step_ms_median=statistics.median(ms),
                tokens_per_s=8 * 128 / (statistics.median(ms) / 1e3),
                losses=whole, printed=lines + lines_r)
    return info


def remat_checks(dev, cfg_full) -> dict:
    """10b's checks at TRAIN_CHECK_LAYERS layers, full width: (a) remat
    none, "full" and "dots" on one micro-batch (bf16 compute): equal loss
    and gradients, each policy's peak; (b) ``make_train_step_accum`` over
    TRAIN_MICRO x TRAIN_N_MICRO sequences against one ``make_train_step``
    on them (f32 compute): the loss, the pre-clip norm and AdamW's first
    moment (0.1 x the clipped gradient after one step); (c) the bf16
    loss against the f32 loss on the same masters and batch."""
    import functools

    from repro_torch.configs.families import lm_opt_config
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import opt_init
    from repro_torch.training.train import (make_train_step,
                                            make_train_step_accum)

    cfg = dataclasses.replace(cfg_full, n_layers=TRAIN_CHECK_LAYERS)
    params = tf.init_master_params(cfg, seed=0, device=dev)
    batch = lm_batch(cfg.vocab_size, TRAIN_MICRO * TRAIN_N_MICRO,
                     train_seq(), dev)
    micro = {k: v[:TRAIN_MICRO] for k, v in batch.items()}
    out = {"layers": TRAIN_CHECK_LAYERS, "peak_gb": {}}
    want = None
    for name, kw in (("none", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(cfg, **kw)
        res = {}
        out["peak_gb"][name] = peak_gb(lambda: res.update(
            lg=loss_and_grads(params, c, micro, torch.bfloat16)))
        loss, grads = res["lg"]
        if want is None:
            want = (loss, grads)
            continue
        out[f"{name}_loss_err"] = abs(float(loss) - float(want[0]))
        out[f"{name}_grad_rel_err"] = rel_err(grads, want[1])
        del grads, res
        errs = out[f"{name}_loss_err"], out[f"{name}_grad_rel_err"]
        if max(errs) > REMAT_TOL:
            raise AssertionError(f"remat {name}: loss and gradients {errs} "
                                 f"from remat=False's (tolerance {REMAT_TOL})")
    del want
    # (c) bf16 compute against f32 compute, forward only
    with torch.no_grad():
        lb = float(tf.loss_fn(params, micro, cfg, torch.bfloat16)[0])
        lf = float(tf.loss_fn(params, micro, cfg, torch.float32)[0])
    out.update(loss_bf16=lb, loss_f32=lf, bf16_loss_err=abs(lb - lf))
    if abs(lb - lf) > BF16_LOSS_TOL:
        raise AssertionError(f"bf16 loss {lb} vs f32 {lf} (tolerance "
                             f"{BF16_LOSS_TOL})")
    # (b) accumulation against the full batch, f32 compute, one step each
    opt_cfg = lm_opt_config(cfg)
    lossf = functools.partial(tf.loss_fn, cfg=cfg,
                              compute_dtype=torch.float32)
    copy_ = tree_map(torch.clone, params)
    state = opt_init(opt_cfg, params)
    _, state, m_full = make_train_step(lossf, opt_cfg)(params, state, batch)
    m1 = state["m"]
    del params, state
    torch.cuda.empty_cache()
    state = opt_init(opt_cfg, copy_)
    _, state, m_acc = make_train_step_accum(lossf, opt_cfg, TRAIN_N_MICRO)(
        copy_, state, batch)
    from repro_torch.training.optimizer import leaves
    got = [t for _, ps in leaves(state["m"]) for t in ps]
    ref = [t for _, ps in leaves(m1) for t in ps]
    la, lf = float(m_acc["loss"]), float(m_full["loss"])
    out.update(accum_loss=la, full_loss=lf, accum_loss_err=abs(la - lf),
               accum_norm_rel_err=abs(float(m_acc["grad_norm"])
                                      / float(m_full["grad_norm"]) - 1),
               accum_moment_rel_err=rel_err(got, ref))
    if max(out["accum_loss_err"], out["accum_norm_rel_err"],
           out["accum_moment_rel_err"]) > ACCUM_TOL:
        raise AssertionError(f"accumulation against the full batch: "
                             f"{out} (tolerance {ACCUM_TOL})")
    del copy_, state, m1, got, ref
    torch.cuda.empty_cache()
    return out


def train_seq() -> int:
    """train_4k's sequence length, from the port's LM shape set."""
    from repro_torch.configs.families import lm_shapes
    return lm_shapes()["train_4k"].dims["seq_len"]


def train_dense(dev) -> dict:
    """10b: chatglm3-6b at full width, TRAIN_DENSE_LAYERS of its 28
    layers, f32 masters, bf16 compute, remat "full", AdamW: steps of
    TRAIN_N_MICRO micro-batches of TRAIN_MICRO sequences of train_4k."""
    import functools

    from repro_torch.configs.families import lm_opt_config
    from repro_torch.configs.lm_archs import LM_CONFIGS
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import adamw_update, opt_init
    from repro_torch.training.train import make_train_step_accum

    full = LM_CONFIGS["chatglm3-6b"]
    info = {"checks": remat_checks(dev, full)}
    cfg = dataclasses.replace(full, n_layers=TRAIN_DENSE_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_master_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    info.update(layers=cfg.n_layers, of_layers=full.n_layers,
                params=cfg.param_count(), init_s=time.perf_counter() - t0,
                weights_gb=tree_bytes(params) / 1e9)
    batch = lm_batch(cfg.vocab_size, TRAIN_MICRO * TRAIN_N_MICRO,
                     train_seq(), dev)
    micro = {k: v[:TRAIN_MICRO] for k, v in batch.items()}
    info["peak_gb_one_micro"] = {
        pol: peak_gb(lambda: loss_and_grads(
            params, dataclasses.replace(cfg, remat_policy=pol), micro,
            torch.bfloat16)) for pol in ("full", "dots")}
    opt_cfg = lm_opt_config(cfg)
    state = opt_init(opt_cfg, params)
    step = make_train_step_accum(
        functools.partial(tf.loss_fn, cfg=cfg, compute_dtype=torch.bfloat16),
        opt_cfg, TRAIN_N_MICRO)
    info.update(step_memory(params, state, batch))
    times, metrics = timed_steps(step, params, state, batch, TRAIN_RUN)
    info["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return finish_train(info, cfg, step, params, state, batch, times,
                        metrics, opt_cfg, adamw_update)


def finish_train(info, cfg, step, params, state, batch, times, metrics,
                 opt_cfg, update) -> dict:
    """The numbers 10b and 10c share: losses, step time (the median of
    the steps after the first), tokens/s, model TFLOP/s, one profiled
    step, the optimizer alone."""
    tokens = batch["tokens"].numel()
    if not all(np.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"{cfg.name}: loss {metrics}")
    step_s = statistics.median(times[1:])
    flops = train_flops(cfg, tokens, batch["tokens"].shape[1])
    info.update(step_s=times, step_s_median=step_s, metrics=metrics,
                tokens_per_step=tokens, tokens_per_s=tokens / step_s,
                model_tflop_per_step=flops / 1e12,
                model_tflops=flops / step_s / 1e12,
                bf16_peak_share=flops / step_s / BF16_OPS_PER_S,
                profile=step_profile(step, params, state, batch, step_s),
                optimizer=optimizer_ms(opt_cfg, params, state, update))
    # the update reads each parameter and its gradient (the parameter's
    # dtype) and writes the parameter; it reads and writes the state
    info["optimizer"]["update_bound_ms"] = bound(
        3 * tree_bytes(params) + 2 * tree_bytes(state), 0)[0]
    return info


@contextlib.contextmanager
def routing_tap(calls: list):
    """Keep each MoE dispatch's ``gate_idx``, ``keep``, ``slot`` and
    ``overflow`` in call order: the forward's layers, then the ones remat
    recomputes in the backward (last layer first)."""
    from repro_torch.models import layers as L
    dispatch = L._moe_dispatch

    def tapped(*a, **kw):
        buf, r, aux = dispatch(*a, **kw)
        calls.append({k: getattr(r, k).clone() for k in
                      ("gate_idx", "keep", "slot", "overflow")})
        return buf, r, aux

    L._moe_dispatch = tapped
    try:
        yield
    finally:
        L._moe_dispatch = dispatch


def train_moe(dev) -> dict:
    """10c: dbrx-132b at full width, TRAIN_MOE_LAYERS of its 40 layers,
    bf16 masters (f32 router), bf16 compute, remat "full", Adafactor,
    one sequence of train_4k a step."""
    import functools

    from repro_torch.configs.families import lm_opt_config
    from repro_torch.configs.lm_archs import LM_CONFIGS
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import adafactor_update, opt_init
    from repro_torch.training.train import make_train_step

    full = LM_CONFIGS["dbrx-132b"]
    cfg = dataclasses.replace(full, n_layers=TRAIN_MOE_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_master_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    info = {"layers": cfg.n_layers, "of_layers": full.n_layers,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "init_s": time.perf_counter() - t0,
            "weights_gb": tree_bytes(params) / 1e9}
    lp = params["layers"][0]
    if lp["moe"]["router"].dtype != torch.float32 or \
            lp["moe"]["w_in"].dtype != torch.bfloat16 or \
            lp["attn_norm"]["scale"].dtype != torch.bfloat16:
        raise AssertionError("dbrx-132b: masters not in the reference's "
                             "dtypes")
    opt_cfg = lm_opt_config(cfg)
    state = opt_init(opt_cfg, params)
    v = state["v"]
    shapes = {"w_in": (tuple(v["layers"]["moe"]["w_in"]["vr"].shape),
                       tuple(v["layers"]["moe"]["w_in"]["vc"].shape)),
              "attn_norm": (tuple(v["layers"]["attn_norm"]["scale"]["vr"]
                                  .shape),
                            tuple(v["layers"]["attn_norm"]["scale"]["vc"]
                                  .shape)),
              "embed": (tuple(v["embed"]["vr"].shape),
                        tuple(v["embed"]["vc"].shape))}
    e, d, f, n = cfg.moe_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    if shapes != {"w_in": ((n, e, d), (n, e, f)), "attn_norm": ((n,), (d,)),
                  "embed": ((cfg.vocab_size,), (d,))}:
        raise AssertionError(f"Adafactor state shapes {shapes}")
    info["adafactor_shapes"] = shapes
    info["adafactor_state_gb"] = tree_bytes(state) / 1e9
    seq = train_seq()
    batch = lm_batch(cfg.vocab_size, 1, seq, dev)
    step = make_train_step(
        functools.partial(tf.loss_fn, cfg=cfg, compute_dtype=torch.bfloat16),
        opt_cfg)
    calls = []
    torch.cuda.reset_peak_memory_stats()
    with routing_tap(calls):
        times, metrics = timed_steps(step, params, state, batch, 1)
    if len(calls) != 2 * n:
        raise AssertionError(f"dbrx-132b: {len(calls)} dispatches, want "
                             f"{2 * n} (forward and recompute)")
    for i in range(n):
        fwd, rc = calls[i], calls[2 * n - 1 - i]
        for k in ("gate_idx", "keep", "slot"):
            if not torch.equal(fwd[k], rc[k]):
                raise AssertionError(f"dbrx-132b layer {i}: the recomputed "
                                     f"{k} differs from the forward's")
    cap = int(cfg.capacity_factor * seq * cfg.moe_top_k / e) + 1
    info["routing"] = {
        "capacity": cap, "entries_per_layer": seq * cfg.moe_top_k,
        "dropped_per_layer": [int((~c["keep"]).sum()) for c in calls[:n]],
        "zeroed_slot0_per_layer": [int(c["overflow"].sum())
                                   for c in calls[:n]],
        "recomputed_equal": True}
    more, more_m = timed_steps(step, params, state, batch, TRAIN_RUN - 1)
    info["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return finish_train(info, cfg, step, params, state, batch, times + more,
                        metrics + more_m, opt_cfg, adafactor_update)


def train_path(dev) -> dict:
    """Phase 10: 10a, 10b and 10c, each on its own memory."""
    out = {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    log(f"[10 train] memory still allocated at the start: "
        f"{out['allocated_at_start_gb']:.2f} GB")
    t0 = time.perf_counter()
    out["10a"] = train_entry_point(dev)
    out["10a"]["s"] = time.perf_counter() - t0
    for key, fn in (("10b", train_dense), ("10c", train_moe)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[key] = fn(dev)
        out[key]["s"] = time.perf_counter() - t0
    return out


def report_train(tr: dict) -> None:
    a = tr["10a"]
    log(f"[10a train] lm100m ({a['params'] / 1e6:.1f}M params) through "
        f"launch.train.main: {a['steps']} steps, loss {a['loss_first']:.4f}"
        f" -> {a['loss_last']:.4f} (mean of the first / last 10: "
        f"{a['loss_mean_first10']:.4f} -> {a['loss_mean_last10']:.4f}); "
        f"{a['resumed_steps']} steps resumed from step {a['steps']}: "
        f"within {a['resume_err']:.3g} of an uninterrupted run (first run "
        f"{a['first_err']:.3g}; tolerance {RESUME_TOL}); step "
        f"{a['step_ms_median']:.1f} ms median, {a['tokens_per_s']:.0f} "
        f"tokens/s; {a['s']:.1f} s")
    for key, name, opt_name in (("10b", "chatglm3-6b", "AdamW"),
                                ("10c", "dbrx-132b", "Adafactor")):
        t, pr, op = tr[key], tr[key]["profile"], tr[key]["optimizer"]
        log(f"[{key} train] {name} at full width, {t['layers']} of "
            f"{t['of_layers']} layers ({t['params'] / 1e9:.2f} B params, "
            f"{t['weights_gb']:.1f} GB of masters), {opt_name}: "
            f"{t['tokens_per_step']} tokens a step; loss "
            f"{[round(m['loss'], 4) for m in t['metrics']]}, grad_norm "
            f"{[round(m['grad_norm'], 3) for m in t['metrics']]}; step "
            f"{t['step_s_median']:.3f} s (steps "
            f"{[round(x, 3) for x in t['step_s']]}), "
            f"{t['tokens_per_s']:.0f} tokens/s, {t['model_tflops']:.1f} "
            f"model TFLOP/s ({t['bf16_peak_share']:.1%} of "
            f"{BF16_OPS_PER_S / 1e12:.0f}); peak memory "
            f"{t['peak_memory_gb']:.1f} GB; one step under the profiler: "
            f"device busy {pr['device_busy_ms']:.1f} ms of "
            f"{pr['wall_ms']:.1f} ms wall, idle share "
            f"{pr['device_idle_share']:.3f}, {pr['launches']:.0f} launches "
            f"(products {pr['matmul_ms']:.1f} ms, softmax "
            f"{pr['softmax_ms']:.1f} ms); "
            f"{opt_name} update {op['update_ms']:.2f} ms (bound "
            f"{op['update_bound_ms']:.2f} ms, bytes), with the norm and clip "
            f"{op['with_norm_and_clip_ms']:.2f} ms; {t['s']:.1f} s")
        log(f"[{key} train] top kernels ms: "
            f"{json.dumps(pr['top_kernels_ms'])}")
    c = tr["10b"]["checks"]
    rounded = {k: {p: round(v, 2) for p, v in d.items()}
               for k, d in (("checks", c["peak_gb"]),
                            ("depth", tr["10b"]["peak_gb_one_micro"]))}
    log(f"[10b train] checks at {c['layers']} layers: remat full / dots vs "
        f"none: loss within {c['full_loss_err']:.3g} / "
        f"{c['dots_loss_err']:.3g}, gradients {c['full_grad_rel_err']:.3g} "
        f"/ {c['dots_grad_rel_err']:.3g} of the largest (tolerance "
        f"{REMAT_TOL}); peak GB none/full/dots "
        f"{json.dumps(rounded['checks'])}; at {tr['10b']['layers']} layers "
        f"full/dots {json.dumps(rounded['depth'])}"
        f" (one micro-batch's forward and backward); accumulation x"
        f"{TRAIN_N_MICRO} vs the full batch (f32): loss "
        f"{c['accum_loss_err']:.3g}, norm {c['accum_norm_rel_err']:.3g}, "
        f"first moment {c['accum_moment_rel_err']:.3g} (tolerance "
        f"{ACCUM_TOL}); bf16 loss {c['loss_bf16']:.4f} vs f32 "
        f"{c['loss_f32']:.4f} (tolerance {BF16_LOSS_TOL})")
    r = tr["10c"]["routing"]
    log(f"[10c train] routing (capacity {r['capacity']} of "
        f"{r['entries_per_layer']} entries): dropped pairs per layer "
        f"{r['dropped_per_layer']}, zeroed slot-0 tokens "
        f"{r['zeroed_slot0_per_layer']}; the backward's recomputed gate_idx,"
        f" keep and slot equal the forward's in every layer; Adafactor "
        f"state {tr['10c']['adafactor_state_gb']:.3f} GB, shapes "
        f"{json.dumps(tr['10c']['adafactor_shapes'])}")


# ---------------------------------------------------------------------------
# Phase 11: the registry and the remaining model families
# ---------------------------------------------------------------------------

def host_draw(kind: str, kw: dict) -> dict:
    """One of phase 11's large numpy draws, in a worker process: a
    ``ClickLog`` batch or a ``make_graph_batch`` block (the port's)."""
    sys.path.insert(0, str(ROOT / "src"))
    if kind == "click":
        from repro_torch.data.recsys import ClickLog
        return ClickLog(**kw["init"]).sample(kw["batch"])
    from repro_torch.data.graph import make_graph_batch
    return make_graph_batch(**kw)


def start_draws(pool) -> dict:
    """Submit the recsys bulk batches (dlrm-rm2's 26 fields and dense
    features; the 39 fields deepfm and autoint share) and the minibatch_lg
    block, all from seed 0."""
    from repro_torch.configs.recsys_archs import RECSYS_CONFIGS
    out = {}
    for name in ("dlrm-rm2", "deepfm"):
        cfg = RECSYS_CONFIGS[name]
        out[name] = pool.submit(host_draw, "click", {
            "init": dict(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense,
                         seed=0), "batch": RECSYS_BULK})
    out["minibatch_lg"] = pool.submit(host_draw, "graph",
                                      gnn_batch_kw("minibatch_lg"))
    return out


def gnn_batch_kw(shape: str) -> dict:
    """``make_graph_batch`` kwargs of a GNN shape at its block dims, the
    triplet cap per edge as the shape gives it (``n_triplets // n_edges``)."""
    from repro_torch.configs.dimenet import GNN_SHAPES
    d = GNN_SHAPES[shape].dims
    return dict(n_nodes=d["n_nodes"], n_edges=d["n_edges"],
                d_feat=d["d_feat"], n_classes=d.get("n_classes", 1),
                t_max=d["n_triplets"],
                cap_per_edge=d["n_triplets"] // d["n_edges"], seed=0)


def smoke_vs_cpu(dev, arch: str) -> dict:
    """The arch's smoke (config, weights, batch) on the CPU and a copy on
    the card: forward, loss and gradients of both, within SMOKE_TOL."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.models import dimenet as dn
    from repro_torch.models import recsys as rs
    spec = get_arch(arch)
    model = dn if spec.family == "gnn" else rs
    cfg, params, _, _, batch = spec.make_smoke(device="cpu")
    lossf = functools.partial(model.loss_fn, cfg=cfg)
    out = {}
    for where in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(where), params)
        b = {k: v.to(where) for k, v in batch.items()}
        with torch.no_grad():
            fwd = model.forward(p, b, cfg)
        out[where] = (fwd, *loss_grads(lossf, p, b))
    (f_cpu, l_cpu, g_cpu), (f_dev, l_dev, g_dev) = out["cpu"], out["cuda"]
    info = {"forward_rel_err": rel_err([f_dev.cpu()], [f_cpu]),
            "loss_cpu": float(l_cpu), "loss_cuda": float(l_dev),
            "grad_rel_err": rel_err([g.cpu() for g in g_dev], g_cpu)}
    info["loss_rel_err"] = abs(info["loss_cuda"] - info["loss_cpu"]) \
        / abs(info["loss_cpu"])
    worst = max(info["forward_rel_err"], info["loss_rel_err"],
                info["grad_rel_err"])
    if not worst <= SMOKE_TOL:
        raise AssertionError(f"{arch}: the card's smoke differs from the "
                             f"CPU's: {info}")
    return info


def registry_path(dev) -> dict:
    """11a: the registry's eleven archs; each trainable one through
    ``launch.train.main`` on the card; has-rag raising; the recsys and
    graph digests; the new families' smokes card against CPU."""
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.data import digests
    from repro_torch.data.graph import make_graph_batch
    from repro_torch.data.recsys import ClickLog, SessionLog
    from repro_torch.launch import train

    got = {s: digests.recsys_digests(ClickLog, SessionLog, s)
           for s in digests.RECSYS_SIZES}
    bad = digests.mismatches(got, digests.RECSYS_PINNED)
    got = {s: digests.graph_digests(make_graph_batch, s)
           for s in digests.GRAPH_SIZES}
    bad += digests.mismatches(got, digests.GRAPH_PINNED)
    if bad:
        raise AssertionError(f"recsys / graph digests differ from the "
                             f"reference's (numpy {np.__version__}): {bad}")
    archs = all_archs()
    trainable = [a for a in archs if get_arch(a).family != "rag"]
    if len(archs) != 11 or len(trainable) != 10:
        raise AssertionError(f"the registry holds {archs}")
    out = {"archs": archs, "cli": {}}
    for arch in trainable:
        t0 = time.perf_counter()
        losses, _ = run_captured(train.main, ["--arch", arch, "--steps",
                                              str(P11_STEPS)])
        if len(losses) != P11_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"--arch {arch}: losses {losses}")
        out["cli"][arch] = {"losses": losses,
                            "s": time.perf_counter() - t0}
    try:
        train.main(["--arch", "has-rag", "--steps", "1"])
    except ValueError as e:
        out["has_rag_raises"] = str(e)
    else:
        raise AssertionError("--arch has-rag did not raise")
    out["smoke_vs_cpu"] = {a: smoke_vs_cpu(dev, a) for a in trainable
                           if get_arch(a).family in ("recsys", "gnn")}
    cfg, fn, args = get_arch("has-rag").make_smoke(device="cpu")
    want = fn(*args)
    got = fn(*[a.to(dev) for a in args])
    for w, g in zip(want[:2], got[:2]):
        if not torch.equal(w, g.cpu()):
            raise AssertionError("has-rag smoke: card ids or accept differ "
                                 "from the CPU's")
    out["has_rag_smoke_equal"] = True
    return out


def mlp_flops(dims) -> int:
    """Multiply-adds of an MLP chain, as operations (2 a MAC)."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def recsys_forward_work(cfg, b: int) -> tuple[float, float]:
    """(bytes, operations) a forward of ``b`` examples needs: the rows it
    gathers, its ids and dense inputs, the dense weights and the outputs
    once; the products and the interactions."""
    f, d = cfg.n_sparse, cfg.embed_dim
    if cfg.kind == "bert4rec":
        s, v = cfg.seq_len, cfg.total_vocab
        n_bytes = b * s * (4 * d + 8) + v * d * 4 + b * s * v * 4
        per_block = 4 * 2 * s * d * d + 2 * 2 * s * s * d \
            + 2 * 2 * s * d * 4 * d
        return n_bytes, b * (cfg.n_blocks * per_block + 2 * s * d * v)
    n_bytes = b * (f * d * 4 + f * 4 + cfg.n_dense * 4 + 4 + 4)
    if cfg.kind == "dlrm":
        fi = f + 1
        ops = mlp_flops((cfg.n_dense,) + cfg.bot_mlp) \
            + fi * (fi - 1) * d \
            + mlp_flops((fi * (fi - 1) // 2 + cfg.bot_mlp[-1],)
                        + cfg.top_mlp)
    elif cfg.kind == "deepfm":
        n_bytes += b * f * 4                       # first-order weights
        ops = 4 * f * d + mlp_flops((f * d,) + cfg.mlp + (1,))
    else:
        h, da = cfg.n_heads, cfg.d_attn
        ops, d_in = 2 * f * h * da, d
        for _ in range(cfg.n_attn_layers):
            ops += 4 * 2 * f * d_in * h * da + 2 * 2 * h * f * f * da
            d_in = h * da
    return n_bytes, b * ops


def call_profile(fn, timer, reps: int) -> dict:
    """A call's time (CUDA events, median of ``reps``, L2 flushed), its
    wall time (host clock to a synchronize, median of 5), one profiled
    call's device busy time, idle share and launches (the trace with the
    most kernel records of PROFILE_TRIES: CUPTI can drop a short call's),
    and its peak memory above what was allocated before."""
    fn()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    counts, times = {}, {}
    for _ in range(PROFILE_TRIES if wall < 100 else 1):
        c = {}
        t = device_times(fn, 1, warm=False, counts=c)
        if sum(c.values()) > sum(counts.values()):
            counts, times = c, t
    busy = sum(times.values()) / 1e3
    return {"ms": timer(fn, reps=reps, warm=1), "wall_ms": wall,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
            "launches": sum(counts.values()), "peak_gb": peak_gb(fn),
            "top_kernels_ms": top_ops(times, 4, 1e3)}


def train_record(step, params, state, batch, opt_cfg, work, n_params,
                 batch_bytes, steps: int = 4) -> dict:
    """``steps`` timed steps (host clock to a synchronize; the median of
    all but the first is the step time, the one step when ``steps`` is
    1), one profiled step, the optimizer alone and the bounds: the step's
    (3 x the forward's operations; reading and writing each parameter and
    both moments, 24 B a parameter, and the batch once) and the update's
    (28 B a parameter, the gradient read too)."""
    from repro_torch.training.optimizer import adamw_update
    mem = step_memory(params, state, batch)
    times, metrics = timed_steps(step, params, state, batch, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"train: loss {metrics}")
    step_s = statistics.median(times[1:] or times)
    rec = {"step_s": times, "step_ms": step_s * 1e3, "metrics": metrics,
           "peak_memory_gb": peak, **mem,
           "profile": step_profile(step, params, state, batch, step_s),
           "optimizer": optimizer_ms(opt_cfg, params, state, adamw_update)}
    rec["bound_ms"], rec["bound_by"] = bound(24 * n_params + batch_bytes,
                                             3 * work)
    rec["optimizer"]["update_bound_ms"] = bound(
        3 * tree_bytes(params) + 2 * tree_bytes(state), 0)[0]
    return rec


def batch_rows(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()}


def ctr_arch(dev, timer, name: str, data: dict) -> dict:
    """11b for one CTR arch at full width: init, one train_batch AdamW
    step (and its record), serve_p99 and serve_bulk forwards, the
    retrieval_cand top-100 against an independent GEMV and stable sort."""
    import functools

    from repro_torch.configs.families import (adamw_step, recsys_shapes,
                                              to_device)
    from repro_torch.configs.recsys_archs import RECSYS_CONFIGS
    from repro_torch.models import recsys as rs
    from repro_torch.training.optimizer import opt_init

    cfg, shapes = RECSYS_CONFIGS[name], recsys_shapes()
    t0 = time.perf_counter()
    params = rs.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    info = {"params": cfg.param_count(), "init_s": time.perf_counter() - t0,
            "weights_gb": tree_bytes(params) / 1e9,
            "table_rows": rs.padded_vocab(cfg)}
    bulk = to_device(data, dev)
    opt_cfg, step = adamw_step(functools.partial(rs.loss_fn, cfg=cfg))
    state = opt_init(opt_cfg, params)
    b = shapes["train_batch"].dims["batch"]
    train_b = batch_rows(bulk, b)
    info["train_batch"] = train_record(
        step, params, state, train_b, opt_cfg,
        recsys_forward_work(cfg, b)[1], cfg.param_count(),
        sum(tree_bytes(v) for v in train_b.values()))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for shape in ("serve_p99", "serve_bulk"):
        b = shapes[shape].dims["batch"]
        sb = batch_rows(bulk, b)
        with torch.no_grad():
            out = rs.forward(params, sb, cfg)
            if tuple(out.shape) != (b,) or not torch.isfinite(out).all():
                raise AssertionError(f"{name} {shape}: {tuple(out.shape)}")
            rec = call_profile(lambda: rs.forward(params, sb, cfg), timer,
                               reps=30 if b <= 512 else 5)
        rec["bound_ms"], rec["bound_by"] = bound(
            *recsys_forward_work(cfg, b))
        info[shape] = rec
    info["retrieval_cand"] = retrieval_cand(dev, timer, cfg, params,
                                            shapes["retrieval_cand"].dims)
    return info


def retrieval_cand(dev, timer, cfg, params, dims) -> dict:
    """One query against the first ``n_candidates`` table rows, top-100;
    the ids against ``torch.mv`` and a stable sort, a difference allowed
    only at a near-tie (the two rows' f64 scores within NEAR_TIE_REL)."""
    from repro_torch.models import recsys as rs
    c, k = dims["n_candidates"], 100
    cands = params["table"][:c]
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((dims["batch"], cfg.embed_dim), generator=g, device=dev)
    batch = {"query": q, "candidates": cands}
    with torch.no_grad():
        vals, idx = rs.retrieval_score(params, batch, cfg, top_k=k)
        ind = torch.sort(torch.mv(cands, q[0]), descending=True,
                         stable=True).indices[:k]
        rec = call_profile(lambda: rs.retrieval_score(params, batch, cfg,
                                                      top_k=k), timer, 30)
    s64 = cands.double() @ q[0].double()
    diff = (idx[0] != ind).nonzero().flatten()
    worst = 0.0
    for p in diff.tolist():
        a, b = s64[idx[0, p]], s64[ind[p]]
        worst = max(worst, float((a - b).abs() / a.abs()))
    if worst > NEAR_TIE_REL:
        raise AssertionError(f"retrieval_cand: ids differ from the GEMV's "
                             f"beyond a near-tie ({worst:.3g})")
    rec.update(ids_equal=not len(diff), near_ties=len(diff),
               near_tie_worst_rel=worst, candidates=c)
    rec["bound_ms"], rec["bound_by"] = bound(
        c * cfg.embed_dim * 4 + cfg.embed_dim * 4 + k * 12,
        2 * c * cfg.embed_dim)
    return rec


def bert4rec_path(dev, timer) -> dict:
    """11b for bert4rec at full width: serve_p99 whole, and the
    train_batch AdamW step through ``make_train_step_accum`` in
    micro-batches of BERT_MICRO sequences (the logits are 21.5 MB a
    sequence in f32)."""
    import functools

    from repro_torch.configs.families import recsys_shapes, to_device
    from repro_torch.configs.recsys_archs import RECSYS_CONFIGS
    from repro_torch.data.recsys import SessionLog
    from repro_torch.models import recsys as rs
    from repro_torch.training.optimizer import OptConfig, opt_init
    from repro_torch.training.train import make_train_step_accum

    cfg, shapes = RECSYS_CONFIGS["bert4rec"], recsys_shapes()
    params = rs.init_params(cfg, seed=0, device=dev)
    info = {"params": cfg.param_count(),
            "weights_gb": tree_bytes(params) / 1e9,
            "table_rows": rs.padded_vocab(cfg)}
    sessions = SessionLog(cfg.total_vocab, seed=0)
    b = shapes["serve_p99"].dims["batch"]
    sb = to_device(sessions.sample(b, cfg.seq_len), dev)
    with torch.no_grad():
        out = rs.forward(params, sb, cfg)
        if tuple(out.shape) != (b, cfg.seq_len, cfg.total_vocab) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"bert4rec serve_p99: {tuple(out.shape)}")
        del out
        rec = call_profile(lambda: rs.forward(params, sb, cfg), timer, 5)
    rec["bound_ms"], rec["bound_by"] = bound(*recsys_forward_work(cfg, b))
    info["serve_p99"] = rec
    del sb
    torch.cuda.empty_cache()
    b = shapes["train_batch"].dims["batch"]
    t0 = time.perf_counter()
    tb = to_device(sessions.sample(b, cfg.seq_len), dev)
    info["train_draw_s"] = time.perf_counter() - t0
    opt_cfg = OptConfig(name="adamw")
    state = opt_init(opt_cfg, params)
    lossf = functools.partial(rs.loss_fn, cfg=cfg)
    # a short accumulation first (the kernels' first calls), then one
    # timed step of the whole batch
    make_train_step_accum(lossf, opt_cfg, 2)(params, state,
                                             batch_rows(tb, 2 * BERT_MICRO))
    step = make_train_step_accum(lossf, opt_cfg, b // BERT_MICRO)
    info["micro_batch"], info["n_micro"] = BERT_MICRO, b // BERT_MICRO
    info["train_batch"] = train_record(
        step, params, state, tb, opt_cfg, recsys_forward_work(cfg, b)[1],
        cfg.param_count(), sum(tree_bytes(v) for v in tb.values()), steps=1)
    return info


def recsys_path(dev, timer, draws) -> dict:
    """11b: dlrm-rm2, deepfm and autoint (the last two on one draw), then
    bert4rec, each on memory freed of the one before."""
    out = {}
    for name, key in (("dlrm-rm2", "dlrm-rm2"), ("deepfm", "deepfm"),
                      ("autoint", "deepfm")):
        t0 = time.perf_counter()
        data = draws[key].result()
        wait = time.perf_counter() - t0
        out[name] = ctr_arch(dev, timer, name, data)
        out[name]["draw_wait_s"] = wait
        out[name]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["bert4rec"] = bert4rec_path(dev, timer)
    out["bert4rec"]["s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gnn_work(cfg, dims) -> tuple[float, float]:
    """(bytes, operations) of one DimeNet forward at a shape's block
    dims: the inputs once; the embedding and the blocks' products."""
    n, e, t = dims["n_nodes"], dims["n_edges"], dims["n_triplets"]
    d, nb, sr = cfg.d_hidden, cfg.n_bilinear, cfg.n_spherical * cfg.n_radial
    n_bytes = n * (cfg.d_feat + 3 + 2) * 4 + e * 9 + t * 9
    ops = 2 * (n * cfg.d_feat * d + e * cfg.n_radial * d + e * 3 * d * d)
    per = 2 * (t * d * d + t * sr * nb + t * nb * d * d + 3 * e * d * d
               + n * d * cfg.n_targets) + t * nb * d
    return n_bytes, ops + cfg.n_blocks * per


def gnn_path(dev, draws) -> dict:
    """11c: one DimeNet AdamW step at full width (6 blocks, d 128, 8
    bilinear, 7 x 6 bases) on full_graph_sm, molecule and minibatch_lg at
    their block dims.  Self-loop edges (``random_graph`` draws them, as the
    reference's does) are masked before the step: a zero-length edge k->j
    drives the reference's upward Bessel recurrence at its 1e-4 clamp to
    ~1e21 (``tests/test_torch_dimenet.py::test_self_loop_edges_blow_up_
    in_both_packages``).  The loss on the unmasked batch is recorded as
    the card's witness of that fault."""
    import functools

    from repro_torch.configs.dimenet import GNN_SHAPES, _cfg_for
    from repro_torch.configs.families import adamw_step, to_device
    from repro_torch.data.graph import make_graph_batch
    from repro_torch.models import dimenet as dn
    from repro_torch.training.optimizer import opt_init

    out = {}
    for shape in GNN_RUN:
        t0 = time.perf_counter()
        dims = GNN_SHAPES[shape].dims
        data = draws[shape].result() if shape in draws \
            else make_graph_batch(**gnn_batch_kw(shape))
        if shape == "molecule":
            data["graph_ids"] = (np.arange(dims["n_nodes"])
                                 // (dims["n_nodes"] // dims["n_graphs"])
                                 ).astype(np.int32)
            data["targets"] = np.random.default_rng(1).normal(
                size=dims["n_graphs"]).astype(np.float32)
        batch = to_device(data, dev)
        cfg = _cfg_for(shape)
        params = dn.init_params(cfg, seed=0, device=dev)
        with torch.no_grad():
            unmasked_loss = float(dn.loss_fn(params, batch, cfg)[0])
        loops = batch["edge_src"] == batch["edge_dst"]
        batch["edge_mask"] &= ~loops
        opt_cfg, step = adamw_step(functools.partial(dn.loss_fn, cfg=cfg))
        state = opt_init(opt_cfg, params)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_bytes, work = gnn_work(cfg, dims)
        rec = train_record(step, params, state, batch, opt_cfg, work,
                           cfg.param_count(), n_bytes)
        rec.update(params=cfg.param_count(), task=cfg.task,
                   self_loops_masked=int(loops.sum()),
                   unmasked_loss=unmasked_loss,
                   triplets=int(batch["tri_mask"].sum()), setup_s=setup_s,
                   s=time.perf_counter() - t0)
        out[shape] = rec
        del params, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def has_rag_path(dev, timer) -> dict:
    """11d: the batched HaS step at HasRagConfig's widths over HASRAG_ROWS
    random rows (f32 corpus, int8 replica, scales), merge_chunks
    HASRAG_CHUNKS.  Batch 0 runs on empty caches (all rejected) and fills
    them with its full-scan results; batch 1 repeats half of batch 0's
    queries with noise and half fresh ones.  The rejected rows' ids must
    equal ``chunked_flat_search`` up to proven near-ties; merge_chunks 0
    and HASRAG_CHUNKS must agree exactly on the first HASRAG_SORT_ROWS
    rows."""
    import functools

    from repro_torch.configs.has_rag import (HasRagConfig,
                                             has_retrieval_step,
                                             quantize_rows)
    from repro_torch.retrieval.flat import chunked_flat_search
    cfg = HasRagConfig()
    n, d, k, b = HASRAG_ROWS, cfg.d, cfg.k, cfg.query_batch
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((n, d), generator=g, device=dev)
    codes = torch.empty((n, d), dtype=torch.int8, device=dev)
    scale = torch.empty(n, device=dev)
    for lo in range(0, n, 1 << 20):
        codes[lo:lo + (1 << 20)], scale[lo:lo + (1 << 20)] = \
            quantize_rows(corpus[lo:lo + (1 << 20)])
    doc_emb = torch.zeros((cfg.doc_cap, d), device=dev)
    doc_ids = torch.full((cfg.doc_cap,), -1, dtype=torch.int32, device=dev)
    q_ids = torch.full((cfg.h_max, k), -1, dtype=torch.int32, device=dev)
    q_valid = torch.zeros(cfg.h_max, dtype=torch.bool, device=dev)
    q0 = torch.randn((b, d), generator=g, device=dev)
    torch.cuda.synchronize()
    info = {"rows": n, "merge_chunks": HASRAG_CHUNKS,
            "store_gb": (tree_bytes([corpus, codes, scale])) / 1e9,
            "setup_s": time.perf_counter() - t0}
    step = functools.partial(has_retrieval_step, k=k, tau=cfg.tau,
                             merge_chunks=HASRAG_CHUNKS)
    with torch.no_grad():
        ids0, acc0, _ = step(corpus, codes, scale, doc_emb, doc_ids, q_ids,
                             q_valid, q0)
        if acc0.any():
            raise AssertionError("has-rag: a query accepted on empty caches")
        q_ids[:b], q_valid[:b] = ids0, True
        uniq = torch.unique(ids0.flatten())
        doc_ids[:len(uniq)] = uniq.int()
        doc_emb[:len(uniq)] = corpus[uniq.long()]
        q1 = torch.randn((b, d), generator=g, device=dev)
        q1[:b // 2] = q0[:b // 2] + 0.05 * q1[:b // 2]
        args = (corpus, codes, scale, doc_emb, doc_ids, q_ids, q_valid, q1)
        ids, acc, best = step(*args)
        rec = call_profile(lambda: step(*args), timer, 5)
        rec["step_args_bytes"] = tree_bytes(args)
        rej = (~acc).nonzero().flatten()
        _, want = chunked_flat_search(corpus, q1[rej], k)
        diff = (ids[rej] != want).nonzero()
        worst = 0.0
        for r, c in diff.tolist():
            qq = q1[rej[r]].double()
            a = corpus[ids[rej[r], c].long()].double() @ qq
            w = corpus[want[r, c].long()].double() @ qq
            worst = max(worst, float((a - w).abs() / w.abs()))
        if worst > NEAR_TIE_REL:
            raise AssertionError(f"has-rag: rejected ids differ from "
                                 f"chunked_flat_search ({worst:.3g})")
        m = HASRAG_SORT_ROWS
        small = (corpus[:m], codes[:m], scale[:m], doc_emb, doc_ids, q_ids,
                 q_valid, q1)
        whole = has_retrieval_step(*small, k=k, tau=cfg.tau, merge_chunks=0)
        chunked = has_retrieval_step(*small, k=k, tau=cfg.tau,
                                     merge_chunks=HASRAG_CHUNKS)
        for x, y in zip(whole, chunked):
            if not torch.equal(x, y):
                raise AssertionError("has-rag: merge_chunks 0 and "
                                     f"{HASRAG_CHUNKS} differ at {m} rows")
    rec["bound_ms"], rec["bound_by"] = bound(n * 3840,
                                             2 * b * d * n * 2)
    info.update(rec, accepted=int(acc.sum()), rejected=len(rej),
                best_accepted_min=float(best[acc].min()) if acc.any()
                else None,
                rejected_ids_equal=not len(diff), near_ties=len(diff),
                near_tie_worst_rel=worst, sort_check_rows=m,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (acc.any() and (~acc).any()):
        raise AssertionError(f"has-rag: accepted {int(acc.sum())} of {b}")
    return info


def phase11(dev) -> dict:
    """Phase 11: 11a the registry, then 11d has-rag, 11c DimeNet and 11b
    recsys, the order in which their host draws are ready."""
    timer = Timer(dev)
    out = {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=ctx) as pool:
        draws = start_draws(pool)
        for key, fn in (("11a", lambda: registry_path(dev)),
                        ("11d", lambda: has_rag_path(dev, timer)),
                        ("11c", lambda: gnn_path(dev, draws)),
                        ("11b", lambda: recsys_path(dev, timer, draws))):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[key] = fn()
            out[key]["phase_s"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()
    return out


def fmt_rec(r: dict) -> str:
    return (f"{r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms, "
            f"{r['bound_by']}), busy {r['device_busy_ms']:.3f} of "
            f"{r['wall_ms']:.3f} ms wall, idle {r['device_idle_share']:.3f},"
            f" {r['launches']:.0f} launches, peak {r['peak_gb']:.2f} GB")


def fmt_train(r: dict) -> str:
    p, o = r["profile"], r["optimizer"]
    return (f"step {r['step_ms']:.1f} ms (bound {r['bound_ms']:.3f} ms, "
            f"{r['bound_by']}; steps {[round(s, 4) for s in r['step_s']]} "
            f"s), loss {[round(m['loss'], 4) for m in r['metrics']]}, busy "
            f"{p['device_busy_ms']:.1f} of {p['wall_ms']:.1f} ms, idle "
            f"{p['device_idle_share']:.3f}, {p['launches']:.0f} launches, "
            f"peak {r['peak_memory_gb']:.2f} GB; AdamW update "
            f"{o['update_ms']:.2f} ms (bound {o['update_bound_ms']:.2f} ms,"
            f" bytes), with norm and clip {o['with_norm_and_clip_ms']:.2f} "
            f"ms")


def report_phase11(p: dict) -> None:
    a = p["11a"]
    log(f"[11a registry] {len(a['archs'])} archs {a['archs']}; "
        f"launch.train.main x{P11_STEPS} steps on the card: " + ", ".join(
            f"{k} {[round(x, 4) for x in v['losses']]} ({v['s']:.1f} s)"
            for k, v in a["cli"].items()))
    log(f"[11a registry] --arch has-rag raises: {a['has_rag_raises']}; "
        f"ClickLog, SessionLog and make_graph_batch digests equal the "
        f"reference's (numpy {np.__version__}); has-rag smoke ids and "
        f"accept equal the CPU's")
    log("[11a registry] smokes card vs CPU (forward / loss / gradients, "
        f"tolerance {SMOKE_TOL}): " + "; ".join(
            f"{k} {v['forward_rel_err']:.3g} / {v['loss_rel_err']:.3g} / "
            f"{v['grad_rel_err']:.3g}" for k, v in
            a["smoke_vs_cpu"].items()) + f"; {a['phase_s']:.1f} s")
    for name in ("dlrm-rm2", "deepfm", "autoint", "bert4rec"):
        r = p["11b"][name]
        head = (f"[11b recsys] {name}: {r['params'] / 1e6:.2f}M params, "
                f"{r['weights_gb']:.2f} GB, table {r['table_rows']} rows")
        if name == "bert4rec":
            log(f"{head}; serve_p99 {fmt_rec(r['serve_p99'])}")
            log(f"[11b recsys] bert4rec train_batch ({r['n_micro']} x "
                f"{r['micro_batch']} sequences): "
                f"{fmt_train(r['train_batch'])}; {r['s']:.1f} s")
            continue
        log(f"{head}, init {r['init_s']:.2f} s, draw wait "
            f"{r['draw_wait_s']:.2f} s; train_batch "
            f"{fmt_train(r['train_batch'])}")
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            extra = ""
            if shape == "retrieval_cand":
                rc = r[shape]
                extra = (f"; ids equal the GEMV + stable sort's: "
                         f"{rc['ids_equal']} ({rc['near_ties']} near-ties)")
            log(f"[11b recsys] {name} {shape}: {fmt_rec(r[shape])}{extra}")
    for shape in GNN_RUN:
        r = p["11c"][shape]
        log(f"[11c dimenet] {shape} ({r['task']}, {r['triplets']} "
            f"triplets, {r['self_loops_masked']} self-loops masked, loss "
            f"{r['unmasked_loss']!r} unmasked, setup {r['setup_s']:.1f} s): "
            f"{fmt_train(r)}")
    h = p["11d"]
    log(f"[11d has-rag] {h['rows']} rows ({h['store_gb']:.1f} GB), "
        f"merge_chunks {h['merge_chunks']}, 64 queries: {fmt_rec(h)}; "
        f"accepted {h['accepted']}, rejected {h['rejected']} (rejected ids "
        f"equal chunked_flat_search: {h['rejected_ids_equal']}, "
        f"{h['near_ties']} near-ties); merge_chunks 0 = "
        f"{h['merge_chunks']} at {h['sort_check_rows']} rows; peak "
        f"{h['peak_memory_gb']:.1f} GB")


# ---------------------------------------------------------------------------
# Phase 12: the dry run, the roofline and the multi-rank exact search
# ---------------------------------------------------------------------------

_CHILDREN: list = []           # processes to stop when the script ends


def stop_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_sweep() -> subprocess.Popen:
    """12c's sweep, ``python -m repro_torch.launch.dryrun --all`` in
    SWEEP_JOBS processes (``meta`` tensors only), started once the timed
    phases are done: CPU work beside phase 11 slowed its host-bound
    steps."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "dryrun.json").unlink(missing_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    with open(out_dir / "dryrun.log", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--jobs", str(SWEEP_JOBS), "--out",
             str(out_dir / "dryrun.json")],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    _CHILDREN.append(proc)
    return proc


def measured_steps(tr: dict, p11: dict) -> dict:
    """12a's measured side, from phases 10 and 11 (nothing run again):
    name -> (step seconds, argument bytes, the step's peak bytes: its
    arguments and the most allocated above the baseline)."""
    dlrm, gnn = p11["11b"]["dlrm-rm2"]["train_batch"], \
        p11["11c"]["minibatch_lg"]
    out = {}
    for name, rec, step_s in (
            ("chatglm3-6b", tr["10b"], tr["10b"]["step_s_median"]),
            ("dlrm-rm2", dlrm, dlrm["step_ms"] / 1e3),
            ("dimenet", gnn, gnn["step_ms"] / 1e3)):
        above = rec["peak_memory_gb"] * 1e9 - rec["step_baseline_bytes"]
        out[name] = (step_s, rec["step_args_bytes"],
                     rec["step_args_bytes"] + above)
    h = p11["11d"]
    out["has-rag"] = (h["ms"] / 1e3, h["step_args_bytes"],
                      h["step_args_bytes"] + h["peak_gb"] * 1e9)
    return out


def dryrun_check(tr: dict, p11: dict) -> dict:
    """12a: the dry run (on ``meta``, in this process) of the four cells
    phases 10 and 11 measured, against what they measured: the peak
    within PEAK_TOL, the arguments, counted against model FLOPs, and the
    step's share of its roofline bound, which must be at most 1."""
    from repro_torch.configs.has_rag import MERGE_CHUNKS
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import run_cell
    if MERGE_CHUNKS != HASRAG_CHUNKS:
        raise AssertionError("12a: the has-rag cell's merge_chunks is not "
                             "11d's")
    measured = measured_steps(tr, p11)
    out = {}
    for name, (shape, variant) in P12_CELLS.items():
        rec = run_cell(name, shape, **variant)
        if not rec["ok"]:
            raise AssertionError(f"12a {name}: {rec['error']}")
        (row,) = rl.analyze([rec])
        step_s, args_b, peak_b = measured[name]
        pred_peak = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
        r = {"shape": shape, "variant": variant, "record": rec, "row": row,
             "step_s": step_s, "args_measured_bytes": args_b,
             "peak_measured_bytes": peak_b, "peak_predicted_bytes": pred_peak,
             "peak_rel_err": pred_peak / peak_b - 1,
             "args_rel_err": rec["argument_size_in_bytes"] / args_b - 1,
             "bound_share": row["bound_s"] / step_s}
        if abs(r["peak_rel_err"]) > PEAK_TOL or \
                abs(r["args_rel_err"]) > PEAK_TOL:
            raise AssertionError(f"12a {name}: predicted peak {pred_peak} "
                                 f"and arguments against {peak_b} and "
                                 f"{args_b}")
        if not 0 < r["bound_share"] <= 1:
            raise AssertionError(f"12a {name}: the bound {row['bound_s']} s "
                                 f"is above the step's {step_s} s")
        out[name] = r
    return out


def dist_inputs(n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """12b's unit-norm corpus [n, 768] and DIST_QUERIES queries, drawn on
    the CPU from a torch generator (every rank draws the same)."""
    g = torch.Generator().manual_seed(seed)
    corpus = torch.randn((n, 768), generator=g)
    q = torch.randn((DIST_QUERIES, 768), generator=g)
    return (corpus / corpus.norm(dim=1, keepdim=True),
            q / q.norm(dim=1, keepdim=True))


def timed_search(search, shard, q, sync) -> tuple:
    """The result and the median host time (ms) of 5 searches."""
    res, times = search(shard, q, K), []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        search(shard, q, K)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return res, statistics.median(times)


def gloo_rank(rank: int, world: int, root: str, n: int) -> None:
    """One gloo rank of 12b on the card's host: its row block of the
    corpus through ``distributed_flat_search``, written to
    ``{root}/gloo_rank{rank}.npz``."""
    from datetime import timedelta

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.retrieval.distributed import distributed_flat_search
    dist.init_process_group("gloo", init_method=f"file://{root}/gloo_rdzv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        corpus, q = dist_inputs(n, 0)
        rows = n // world
        (s, i), ms = timed_search(distributed_flat_search(),
                                  corpus[rank * rows:(rank + 1) * rows], q,
                                  lambda: None)
        np.savez(f"{root}/gloo_rank{rank}.npz", s=s.numpy(), i=i.numpy(),
                 ms=ms)
    finally:
        dist.destroy_process_group()


def distributed_path(dev) -> dict:
    """12b: ``distributed_flat_search`` at NCCL world 1 on the card (NCCL
    takes one rank a card, and this machine has one) and at gloo world
    DIST_WORLD in CPU processes on its host, each against
    ``chunked_flat_search`` on the card over the same corpus: ids equal
    except at near-ties proven by recomputed scores."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.retrieval.distributed import distributed_flat_search
    from repro_torch.retrieval.flat import chunked_flat_search
    root = ROOT / "chiprun_out" / "p12"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    corpus, q = dist_inputs(DIST_ROWS, 0)
    c_dev, q_dev = corpus.to(dev), q.to(dev)
    want_s, want_i = chunked_flat_search(c_dev, q_dev, K)
    want_s, want_i = want_s.cpu(), want_i.cpu()

    def score_of(row, i):
        return float(corpus[i].double() @ q[row].double())

    def held(what, s, i) -> dict:
        err, swaps = compare_topk(what, s, i, want_s, want_i, score_of)
        return {"ids_equal": bool(torch.equal(i, want_i)),
                "near_ties": swaps, "score_err": err}

    out = {}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl_rdzv",
                            rank=0, world_size=1)
    try:
        (s, i), ms = timed_search(distributed_flat_search(), c_dev, q_dev,
                                  torch.cuda.synchronize)
    finally:
        dist.destroy_process_group()
    out["nccl"] = {**held("12b nccl", s.cpu(), i.cpu()), "world": 1,
                   "search_ms": ms, "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ctx = tmp.start_processes(gloo_rank, args=(DIST_WORLD, str(root),
                                               DIST_ROWS),
                              nprocs=DIST_WORLD, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + DIST_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"12b: {DIST_WORLD} gloo ranks not "
                                     f"done in {DIST_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [np.load(root / f"gloo_rank{r}.npz") for r in range(DIST_WORLD)]
    for r in ranks[1:]:
        if not (np.array_equal(r["s"], ranks[0]["s"])
                and np.array_equal(r["i"], ranks[0]["i"])):
            raise AssertionError("12b gloo: the ranks' results differ")
    s, i = torch.from_numpy(ranks[0]["s"]), torch.from_numpy(ranks[0]["i"])
    out["gloo"] = {**held("12b gloo", s, i), "world": DIST_WORLD,
                   "search_ms": float(ranks[0]["ms"]),
                   "s": time.perf_counter() - t0}
    return out


def sweep_path(sweep, started: float) -> dict:
    """12c: the ``--all`` sweep's records (every cell OK, every key) and
    their roofline, written beside them, each cell's bound at most the
    larger of its predicted compute and traffic; then one decode cell on
    ``meta`` in this process (the kernels' counts are read after phase
    12)."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    try:
        code = sweep.wait(timeout=SWEEP_WAIT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"12c: the sweep did not end within "
                             f"{SWEEP_WAIT_S} s of phase 12") from None
    waited = time.perf_counter() - t0
    wall = time.perf_counter() - started
    out_dir = ROOT / "chiprun_out"
    if code != 0:
        raise AssertionError(f"12c: the sweep exited {code} (dryrun.log)")
    recs = json.loads((out_dir / "dryrun.json").read_text())
    keys = ("mesh", "n_devices", "lower_s", "flops_per_device",
            "flops_by_dtype", "bytes_per_device", "argument_size_in_bytes",
            "output_size_in_bytes", "argument_read_bytes",
            "output_written_bytes", "temp_size_in_bytes", "fits_one_card",
            "collectives")
    bad = [f"{r['arch']} {r['shape']}" for r in recs
           if not r["ok"] or any(k not in r for k in keys)]
    if len(recs) != SWEEP_CELLS or bad:
        raise AssertionError(f"12c: {len(recs)} records, failed: {bad}")
    rows = rl.analyze(recs)
    over = [f"{r['arch']} {r['shape']}" for r in rows
            if r["bound_s"] > max(r["t_compute_s"], r["t_memory_s"])]
    if over:
        raise AssertionError(f"12c: bound above the dry run's prediction "
                             f"in {over}")
    (out_dir / "roofline.md").write_text(rl.to_markdown(rows) + "\n")
    (out_dir / "roofline.json").write_text(json.dumps(rows, indent=1))
    dec = run_cell("chatglm3-6b", "long_500k")
    if not dec["ok"]:
        raise AssertionError(f"12c: the decode cell on meta: {dec}")
    return {"cells": len(recs), "fit": sum(r["fits_one_card"] for r in recs),
            "sweep_s": sum(r["lower_s"] for r in recs), "waited_s": waited,
            "wall_s": wall,
            "largest": max(recs, key=lambda r: r["argument_size_in_bytes"]
                           + r["temp_size_in_bytes"]),
            "decode_cell": dec, "roofline": rows}


def report_phase12(p: dict) -> None:
    for name, r in p["12a"].items():
        rec, row = r["record"], r["row"]
        var = "".join(f", {k}={v}" for k, v in sorted(r["variant"].items()))
        log(f"[12a dryrun] {name} {r['shape']}{var}: peak predicted "
            f"{r['peak_predicted_bytes'] / 1e9:.2f} GB (arguments "
            f"{rec['argument_size_in_bytes'] / 1e9:.2f} + temp "
            f"{rec['temp_size_in_bytes'] / 1e9:.2f}), measured "
            f"{r['peak_measured_bytes'] / 1e9:.2f} GB (arguments and "
            f"max_memory_allocated above the baseline) "
            f"({r['peak_rel_err']:+.1%}, tolerance {PEAK_TOL:.0%}); arguments"
            f" {rec['argument_size_in_bytes'] / 1e9:.2f} / "
            f"{r['args_measured_bytes'] / 1e9:.2f} GB; FLOPs counted "
            f"{rec['flops_per_device'] / 1e12:.2f} T, model "
            f"{row['model_flops_total'] / 1e12:.2f} T, the bound's products "
            f"{row['bound_flops'] / 1e12:.2f} T; bound "
            f"{row['bound_s'] * 1e3:.2f} ms ({row['bound_by']}), step "
            f"{r['step_s'] * 1e3:.2f} ms: the step's share of its bound "
            f"{r['bound_share']:.3f}")
    for key in ("nccl", "gloo"):
        d = p["12b"][key]
        where = ("on the card" if key == "nccl" else
                 "in CPU processes on the card's host (one card: four "
                 "cards were not available)")
        log(f"[12b distributed] {key} world {d['world']} {where}, "
            f"{DIST_ROWS} x 768 rows, {DIST_QUERIES} queries, k={K}: ids "
            f"equal chunked_flat_search's: {d['ids_equal']} "
            f"({d['near_ties']} near-ties), score error {d['score_err']:.3g};"
            f" a search {d['search_ms']:.3f} ms (host clock, median of 5); "
            f"{d['s']:.1f} s with setup")
    c = p["12c"]
    big = c["largest"]
    dec = c["decode_cell"]
    log(f"[12c sweep] {c['cells']} cells OK, {c['fit']} fit one card "
        f"(arguments + temp within 80 GB); the largest "
        f"{big['arch']} {big['shape']}, "
        f"{(big['argument_size_in_bytes'] + big['temp_size_in_bytes']) / 1e9:.1f}"
        f" GB; every bound at most the larger of the predicted compute and "
        f"traffic; the cells' counted calls took {c['sweep_s']:.1f} s in "
        f"{SWEEP_JOBS} processes, {c['wall_s']:.1f} s from the sweep's start"
        f" to its end, {c['waited_s']:.1f} s waited after 12a; "
        f"chiprun_out/dryrun.json, roofline.md")
    log(f"[12c sweep] chatglm3-6b long_500k on meta in this process: "
        f"{dec['flops_per_device'] / 1e12:.3f} TFLOP counted "
        f"(decode_attention by its own formula), the eight kernels' "
        f"launches after phase 12: {p['launches']}")


def stream_kw() -> dict:
    from repro_torch.data.synthetic import DATASETS
    ds = DATASETS["granola"]
    return dict(pattern=ds["pattern"], zipf_a=ds["zipf_a"],
                p_uncovered=ds["p_uncovered"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels import fused_rerank_probe as fr_probe
    from repro_torch.kernels.fused_rerank import fused_scores
    from repro_torch.kernels.homology_score import homology_score
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.kernels.lexical_score import lexical_score
    from repro_torch.kernels.topk_search import topk_search

    counters = Counters({
        "topk_search": (topk_search, "launches"),
        "ivf_scan": (ivf_scan, "launches"),
        "homology_score": (homology_score, "launches"),
        "ivf_scan_int8": (ivf_scan, "launches_int8"),
        "lexical_score": (lexical_score, "launches"),
        "fused_rerank": (fused_scores, "launches"),
        "decode_attention": (decode_attention, "launches"),
        "embedding_bag": (embedding_bag, "launches")})
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    tf32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, TF32 {tf32}")
    if tf32["cuda.matmul.allow_tf32"]:
        raise AssertionError("TF32 matmul is on; the port needs full f32")

    # phase 2: build (and fused_rerank's traced variant for its probe),
    # while the worlds are built and held to the reference's digests
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        traced = pool.submit(fr_probe.build_traced)
        worlds = pool.submit(world_digests)
        paths = _build.build_all()
        traced = traced.result()
        build_s = time.perf_counter() - t0
        digest_info, world = worlds.result()
    log(f"kernels built in {build_s:.1f} s: "
        f"{sorted(p.name for p in paths.values())}")
    ptxas = {name: ptxas_summary(out)
             for name, out in _build.build_log.items()}
    for name, fns in ptxas.items():
        log(f"  {name} (ptxas -v): " + "; ".join(
            f"{fn} {r.get('registers')} regs, {r.get('smem', 0)} B static "
            f"smem, {r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} B "
            f"spill st/ld" for fn, r in fns.items()))
    dyn_smem = {
        "decode_attn_mma_kernel<128,1> (chatglm3-6b, G=16)": _build.library(
            "decode_attention").has_decode_attention_smem(128, 16, 1, 1),
        "decode_attn_mma_kernel<128,2> (G=17-32)": _build.library(
            "decode_attention").has_decode_attention_smem(128, 32, 1, 1),
        **{f"topk_scan_kernel tile {t} (k={K})": _build.library(
            "topk_search").has_topk_search_smem(t, K) for t in range(3)},
        f"{LEXICAL_KERNEL} (tile_n 512)": _build.library(
            "lexical_score").has_lexical_smem(512)}
    log(f"  dynamic shared memory per block (bytes): {json.dumps(dyn_smem)}")

    # phase 3: kernels against their plain versions
    timer = Timer(dev)
    t0 = time.perf_counter()
    kres = check_kernels(dev, timer)
    torch.cuda.empty_cache()
    kres.update(check_hybrid_kernels(dev, timer))
    kres["fused_rerank"]["trace_us"] = {
        f"B={b}": fr_probe.trace_phases(traced, dev, b) for b in (1, 64)}
    torch.cuda.empty_cache()
    kres.update(check_decode_attention(dev, timer))
    torch.cuda.empty_cache()
    bag_res, bag_path = check_embedding_bag(dev, timer)
    kres.update(bag_res)
    torch.cuda.empty_cache()                      # the tables are gone
    check_cloud_path_shapes(dev, timer, kres)
    phase3_s = time.perf_counter() - t0
    log(f"tolerance vs plain: scores within {SCORE_TOL} (f32 sums in "
        f"another order), ids equal except swaps of candidates whose "
        f"scores lie within it; unweighted homology, lexical scores and "
        f"ids, fused masses and vals, homology best and slot and the "
        f"EmbeddingBag bit-equal; weighted homology within 1e-6 (best and "
        f"slot bit-equal for weights in 1/64ths); fused ids equal except "
        f"between equal masses whose rscores lie within {SCORE_TOL} and in "
        f"rows with a cosine within 1e-5 of the threshold; decode "
        f"attention within {DECODE_TOL} "
        f"(rtol and atol)")
    for name, r in kres.items():
        for key, t in r.items():
            if not (isinstance(t, dict) and "ms" in t):
                continue
            lib = "n/a" if t["library_ms"] is None \
                else f"{t['library_ms']:.4f}"
            log(f"{name} {key}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {lib} ms, bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}); kernels alone "
                f"{t['kernel_device_us']:.1f} us (profiler); max_abs_err "
                f"{r['max_abs_err']:.3g}, near-tie swaps "
                f"{r.get('swaps', 0)}")
    for name, key in (("homology_score", "validation_to_accept"),
                      ("fused_rerank", "split_vs_one_launch")):
        for b in (1, 64):
            t = kres[name][f"B={b}"]
            log(f"{name} B={b}: one launch a call; kernel alone "
                f"{t['kernel_device_us']:.2f} us, scores only "
                f"{t['scores_only_device_us']:.2f} us (profiler); " + "; ".join(
                    f"{seq} sequence {v['ms']:.4f} ms, device "
                    f"{v['device_us']:.2f} us, {v['launches']:.0f} launches"
                    for seq, v in t[key].items()))
    log("lexical_score cases (bit-equal; launches a call): " + "; ".join(
        f"{c} {v['launches']}" for c, v in
        kres["lexical_score"]["cases"].items() if "launches" in v)
        + "; 200 calls back to back and two streams, tickets and bitmaps 0 "
        "after; one launch a call at B=1 and 64 (profiler)")
    for b, ph in kres["fused_rerank"]["trace_us"].items():
        log(f"fused_rerank probe ({FUSED_KERNEL} phases, -DFUSED_RERANK_TRACE,"
            f" {b}, P={POOL}, d=768, diversify 0.98), us: " + "; ".join(
                f"{k} {v:.3f}" for k, v in ph.items()))
    for name in BAG_TABLES:
        log(f"embedding_bag {name} host/device split per call: " + "; ".join(
            f"{what} host {s['host_us']:.2f} us (perf_counter, 200 calls, "
            f"median of 5), device {s['device_us']:.2f} us in "
            f"{s['launches']:.0f} launches (profiler: "
            f"{', '.join(s['kernels_us'])})"
            for what, s in kres["embedding_bag"][name]["split"].items()))
    log(f"embedding_bag lookup path: {bag_path['batches']} batches of "
        f"{BAG_BATCH} through embedding_bag_op, launches "
        f"{bag_path['launches']['embedding_bag']}")

    # phases 4-5, on configuration 1's world (built in phase 2)
    world_s = digest_info["s"]
    queries = world.sample_queries(HAS_QUERIES, **stream_kw(), seed=1)
    log(f"world: {world.cfg.n_docs} passages, d=768; both worlds and "
        f"their digests in {world_s:.1f} s (numpy {np.__version__}), equal "
        f"to the reference's")
    info, index, service = algorithm1_path(dev, world, queries, counters)
    hyb = hybrid_path(dev, world, queries, index, counters)
    for title, r in (("Algorithm 1", info), ("hybrid cloud stage", hyb)):
        f, s = r["full"], r["has"]
        log(f"[{title}] full: AvgL {f['avg_latency_s']:.4f} s, DocHit "
            f"{f['doc_hit_rate']:.4f}, RA {f['ra_qwen3-8b']:.4f}")
        log(f"[{title}] HaS: AvgL {s['avg_latency_s']:.4f} s, DAR "
            f"{s['dar']:.4f}, CAR {s['car']:.4f}, DocHit "
            f"{s['doc_hit_rate']:.4f}, RA {s['ra_qwen3-8b']:.4f}; "
            f"{HAS_QUERIES} queries in {r['has_serve_s']:.1f} s")
        log(f"[{title}] launches: {r['launches']}")
        for key, what in (("profile", "window of 100 fresh queries"),
                          ("profile_cloud", "cloud stage alone, 100 queries")):
            if key not in r:
                continue
            for tag, pr in (("", r[key]), (" (split)",
                                           r[key + "_split"])):
                log(f"[{title}] {what}{tag} ({pr['accepted']} accepted): "
                    f"{pr['wall_us_per_step']:.1f} us/step wall, device busy "
                    f"{pr['device_busy_us_per_step']:.1f} us/step (profiler), "
                    f"{pr['device_ops_per_step']:.1f} device ops/step, idle "
                    f"share {pr['device_idle_share']:.3f}; top kernels "
                    f"us/step: {json.dumps(pr['top_kernels_us_per_step'])}")
        log(f"[{title}] replay ({r['replay']['queries']} queries, "
            f"backend=torch): accept bits equal, near-tie id swaps "
            f"{r['replay']['near_tie_swaps']}")

    # phase 6: the RAG generator
    rag = rag_path(dev, world, service, index, counters)
    sm, pr, rp = rag["summary"], rag["profile"], rag["replay"]
    log(f"[RAG] chatglm3-6b ({rag['params'] / 1e9:.2f} B params, bf16, 28 "
        f"layers; weights drawn in {rag['init_params_s']:.1f} s): "
        f"{sm['requests']} requests, batch {RAG_BATCH}, prompt "
        f"{RAG_PROMPT}, {RAG_GEN} decode steps in {rag['serve_s']:.1f} s; "
        f"peak memory {rag['peak_memory_gb']:.1f} GB")
    log(f"[RAG] TTFT (prefill, batch of {RAG_BATCH}) mean "
        f"{sm['ttft_avg_s'] * 1e3:.1f} ms, per batch "
        f"{[round(t * 1e3, 1) for t in rag['ttft_s']]} ms; decode "
        f"{sm['decode_tps_avg']:.1f} tokens/s mean, per batch "
        f"{[round(t, 1) for t in rag['decode_tps']]}; retrieval DAR "
        f"{sm['dar']:.4f}; {rag['distinct_tokens']} distinct tokens")
    log(f"[RAG] launches: {rag['launches']}")
    log(f"[RAG] decode window of {pr['steps']} steps (batch "
        f"{RAG_BATCH}): {pr['wall_us_per_step']:.1f} us/step wall, device "
        f"busy {pr['device_busy_us_per_step']:.1f} us/step (profiler), idle "
        f"share {pr['device_idle_share']:.3f}, "
        f"{pr['launches_per_step']:.0f} kernel launches/step; "
        f"decode_attention "
        f"{pr['decode_attention_us_per_step']:.1f} us/step; top kernels "
        f"us/step: {json.dumps(pr['top_kernels_us_per_step'])}")
    pp = rag["prefill_profile"]
    log(f"[RAG] one prefill (batch {RAG_BATCH} x {RAG_PROMPT}): device busy "
        f"{pp['device_busy_ms']:.1f} ms (profiler); top kernels ms: "
        f"{json.dumps(pp['top_kernels_ms'])}")
    log(f"[RAG] replay of batch 0, backend=torch vs the kernel: "
        f"{rp['tokens_equal']}/{RAG_BATCH} rows' tokens equal; logits "
        f"within {rp['max_logit_err']:.4g} (tolerance {LOGIT_TOL}) until a "
        f"row's tokens part; parted at proven near-ties: "
        f"{rp['parted_rows']}")

    # phase 6b: the MoE generators at full width, cut in depth
    t0 = time.perf_counter()
    moe = moe_path(dev, world, service, index, counters)
    moe_s = time.perf_counter() - t0
    report_moe(moe)
    log(f"[MoE] phase 6b in {moe_s:.1f} s")

    # phase 7: the micro-batched and tenant-partitioned engine, baselines
    bat = batched_path(dev, world, queries, service, index, counters)
    report_batched(bat)
    qs = quickstart_twin(dev)
    rt = rag_twin(dev)
    log(f"[RAG twin] examples/rag_serving_torch.py, {RAG_TWIN_REQUESTS} "
        f"requests on {rt['device']} in {rt['s']:.1f} s: DAR "
        f"{rt['summary']['dar']:.4f}, TTFT mean "
        f"{rt['summary']['ttft_avg_s'] * 1e3:.2f} ms, decode "
        f"{rt['summary']['decode_tps_avg']:.1f} tokens/s")
    t0 = time.perf_counter()
    sp = scheduler_path(dev, world, queries, service, index, counters)
    sp["phase_s"] = time.perf_counter() - t0
    report_scheduler(sp)
    log(f"[scheduler] phase 8 in {sp['phase_s']:.1f} s")
    log(f"[quickstart twin] {qs['n_docs']} passages, d=64, {HAS_QUERIES} "
        f"queries on {qs['device']} in {qs['s']:.1f} s: full DocHit "
        f"{qs['full']['doc_hit_rate']:.4f}; HaS DAR {qs['has']['dar']:.4f}, "
        f"CAR {qs['has']['car']:.4f}, DocHit "
        f"{qs['has']['doc_hit_rate']:.4f}")
    # the full scan is exact: on the reference's world and stream its doc
    # hits are the CPU reference's
    for size, hit in (("config1", info["full"]["doc_hit_rate"]),
                      ("quickstart", qs["full"]["doc_hit_rate"])):
        if round(hit * FULL_QUERIES) != REF_FULL_DOC_HITS[size]:
            raise AssertionError(
                f"{size}: full-scan DocHit {hit} on the card, the CPU "
                f"reference's {REF_FULL_DOC_HITS[size] / FULL_QUERIES}")
    log(f"full-scan DocHit equals the CPU reference's: configuration 1 "
        f"{info['full']['doc_hit_rate']:.4f}, quickstart "
        f"{qs['full']['doc_hit_rate']:.4f}")

    # phase 9: the cloud backends, live ingest, replicas, agentic serving
    # and the serve CLI
    t0 = time.perf_counter()
    p9 = {"sharded": sharded_path(dev, world, queries, service, index,
                                  counters)}
    p9["hybrid_sharded"] = hybrid_sharded_path(dev, world, queries, index,
                                               counters)
    p9["ingest"] = ingest_path(dev, world, queries, counters)
    p9["replica"] = replica_path(dev, world, queries, service, index,
                                 counters)
    p9["agentic"] = agentic_path(dev, world, service, index, counters)
    p9["cli"] = cli_path(counters)
    p9["phase_s"] = time.perf_counter() - t0
    p9["launches"] = phase9_launches(p9)
    report_phase9(p9)

    # phase 10: the LM training path, on a card freed of the worlds,
    # indexes and weights of the earlier phases
    del world, queries, index, service, timer
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    t0 = time.perf_counter()
    tr = train_path(dev)
    tr["phase_s"] = time.perf_counter() - t0
    tr["launches"] = counters.read()
    report_train(tr)
    if any(tr["launches"].values()):
        raise AssertionError(f"training launched a retrieval or serving "
                             f"kernel: {tr['launches']}")
    log(f"[10 train] phase 10 in {tr['phase_s']:.1f} s; the eight "
        f"kernels' launches: {tr['launches']} (training runs none)")

    # phase 11: the registry and the remaining model families (recsys,
    # DimeNet, has-rag) at full width, on a card freed of phase 10's
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    t0 = time.perf_counter()
    p11 = phase11(dev)
    p11["phase_s"] = time.perf_counter() - t0
    p11["launches"] = counters.read()
    report_phase11(p11)
    if any(p11["launches"].values()):
        raise AssertionError(f"phase 11 launched a retrieval or serving "
                             f"kernel: {p11['launches']}")
    log(f"[11] phase 11 in {p11['phase_s']:.1f} s; the eight kernels' "
        f"launches: {p11['launches']} (these families run none)")

    # phase 12: the multi-rank exact search, then the sweep on the host
    # beside the dry run of the steps phases 10 and 11 measured
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    t0 = time.perf_counter()
    p12b = distributed_path(dev)
    t_sweep, sweep = time.perf_counter(), start_sweep()
    p12 = {"12a": dryrun_check(tr, p11), "12b": p12b,
           "12c": sweep_path(sweep, t_sweep)}
    p12["launches"] = counters.read()
    p12["phase_s"] = time.perf_counter() - t0
    report_phase12(p12)
    if any(p12["launches"].values()):
        raise AssertionError(f"phase 12 launched a kernel: "
                             f"{p12['launches']}")
    log(f"[12] phase 12 in {p12['phase_s']:.1f} s; the eight kernels' "
        f"launches: {p12['launches']} (the dry run counts decode_attention "
        f"on meta and launches nothing)")

    # phase 13: the kernels line and the result line
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {
        "topk_search": ("topk_search.cu", "src/repro/kernels/topk_search.py:25",
                        info),
        "ivf_scan": ("ivf_scan.cu", "src/repro/kernels/ivf_scan.py:19", info),
        "homology_score": ("homology_score.cu",
                           "src/repro/kernels/homology_score.py:17", info),
        "ivf_scan_int8": ("ivf_scan.cu", "src/repro/kernels/ivf_scan.py:72",
                          hyb),
        "lexical_score": ("lexical_score.cu",
                          "src/repro/kernels/lexical_score.py:107", hyb),
        "fused_rerank": ("fused_rerank.cu",
                         "src/repro/kernels/fused_rerank.py:84", hyb),
        "decode_attention": ("decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:21", rag),
        "embedding_bag": ("embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:19", bag_path)}
    main_shape = {"decode_attention": "rag", "embedding_bag": "dlrm-rm2"}
    for name in RETRIEVAL_KERNELS:
        if p9["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 9's "
                                 "paths")
    kernels = []
    for name, (src, replaces, path) in sources.items():
        t = kres[name][main_shape.get(name, "B=1")]
        # the retrieval kernels' launches on phase 9's paths; the RAG and
        # recsys kernels' on their own paths (phase 9 runs neither)
        launches = p9["launches"][name] if name in RETRIEVAL_KERNELS \
            else path["launches"][name]
        if name == "decode_attention":            # phase 6 and phase 6b
            launches += sum(m["launches"][name] for m in moe.values())
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces,
                        "launches": launches,
                        "max_abs_err": kres[name]["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "tf32": tf32, "build_s": build_s, "build_log": _build.build_log,
         "ptxas": ptxas, "dynamic_smem": dyn_smem,
         "phase3_s": phase3_s, "world_build_s": world_s, "kernels": kres,
         "main_path": info, "hybrid_path": hyb, "rag_path": rag,
         "moe_path": moe, "moe_phase_s": moe_s, "rag_twin": rt,
         "batched_path": bat, "quickstart_twin": qs, "scheduler_path": sp,
         "embedding_bag_path": bag_path, "world_digests": digest_info,
         "phase9": p9, "train_path": tr, "phase11": p11, "phase12": p12,
         "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
