"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # from the root of the repository

Phases (any failure exits non-zero; no phase catches and carries on):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   both TF32 flags (TF32 must stay off: the port's f32 products are full
   f32);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel);
3. hold each of the eight kernels against its plain PyTorch version at the
   main-path shapes (B=1 and B=64; the tenant path's B=32 shapes: grouped
   topk_search over 4 x 50,000 rows, ivf_scan at P=64, grouped
   homology_validate over 4 x 5000 rows with an empty tenant; the
   scheduler's: topk_search B=32 over one 50,000-row ring,
   homology_validate B=16 with padded rows (re-validation), homology_score
   288 x 288 drafts against themselves (sharing);
   topk_search also at B=7 and B=65 and at k=1 and k=100; ivf_scan in
   both modes also at B=7 and 65, k=1 and MAX_K, P=1 and 512, a pool
   smaller than k, all-pad pools, clamped probes, a tie between two probes, d=770, 200 calls back to back and
   two streams, one launch per call; decode attention at the RAG shape
   for chatglm3-6b's G=16 and the G=4 and G=9 of the other dense configs,
   decode_32k and long_500k; the EmbeddingBag at the deepfm and dlrm-rm2
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
   ``examples/quickstart_torch.py`` at its own size;
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
9. the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Details of every phase are written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import re
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
        b, s = k.shape[:2]
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


def decode_run(params, cfg, prompt, backend):
    """One batch through prefill and RAG_GEN greedy decode steps, keeping
    every step's logits (f32): (tokens [B, RAG_GEN+1], logits)."""
    from repro_torch.models import transformer as tf
    from repro_torch.utils import first_argmax

    b, n = prompt.shape
    lg = tf.prefill(params, prompt, cfg)
    cache = tf.init_kv_cache(cfg, b, n + RAG_GEN, device=prompt.device)
    toks, logits = [first_argmax(lg).int()], [lg.float()]
    for j in range(RAG_GEN):
        lg, cache = tf.decode_step(params, cache, toks[-1], n + j, cfg,
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
    from repro_torch.utils import first_argmax

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
    first = first_argmax(tf.prefill(params, prompt, cfg)).int()

    def window():
        cache = tf.init_kv_cache(cfg, RAG_BATCH, RAG_PROMPT + RAG_GEN,
                                 device=dev)
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
    info["profile"] = {
        "steps": RAG_GEN, "wall_us_per_step": wall_us,
        "device_busy_us_per_step": busy,
        "device_idle_share": 1.0 - busy / wall_us,
        "launches_per_step": sum(counts.values()) / RAG_GEN,
        "decode_attention_us_per_step": own_kernel_us(
            times, DECODE_KERNELS)
        / RAG_GEN,
        "top_kernels_us_per_step": top_ops(times, 10, RAG_GEN)}

    pre = device_times(lambda: tf.prefill(params, prompt, cfg), 1)
    info["prefill_profile"] = {
        "device_busy_ms": sum(pre.values()) / 1e3,
        "top_kernels_ms": top_ops(pre, 8, 1e3)}

    tk, lk = decode_run(params, cfg, prompt, None)
    if not torch.equal(tk.cpu(), torch.as_tensor(res.tokens[:RAG_BATCH])):
        raise AssertionError("RAG replay: the kernel run does not repeat "
                             "serve_rag's tokens")
    tp, lp = decode_run(params, cfg, prompt, "torch")
    info["replay"] = compare_greedy(tk, lk, tp, lp)
    del params
    torch.cuda.empty_cache()
    return info


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
    from repro_torch.data.synthetic import SyntheticWorld, WorldConfig
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

    # phase 2: build (and fused_rerank's traced variant for its probe)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        traced = pool.submit(fr_probe.build_traced)
        paths = _build.build_all()
        traced = traced.result()
    build_s = time.perf_counter() - t0
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

    # phases 4-5
    t0 = time.perf_counter()
    world = SyntheticWorld(WorldConfig(n_entities=ENTITIES, d=768))
    world_s = time.perf_counter() - t0
    queries = world.sample_queries(HAS_QUERIES, **stream_kw(), seed=1)
    log(f"world: {world.cfg.n_docs} passages, d=768, built in "
        f"{world_s:.1f} s")
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

    # phase 7: the micro-batched and tenant-partitioned engine, baselines
    bat = batched_path(dev, world, queries, service, index, counters)
    report_batched(bat)
    qs = quickstart_twin(dev)
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

    # phase 9: the kernels line and the result line
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
    kernels = []
    for name, (src, replaces, path) in sources.items():
        t = kres[name][main_shape.get(name, "B=1")]
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces,
                        "launches": path["launches"][name],
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
         "batched_path": bat, "quickstart_twin": qs, "scheduler_path": sp,
         "embedding_bag_path": bag_path,
         "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
