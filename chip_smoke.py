"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # from the root of the repository

Phases (any failure exits non-zero; no phase catches and carries on):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   both TF32 flags (TF32 must stay off: the port's f32 products are full
   f32);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version at the main-path
   shapes (B=1 and B=64) and at edge cases; time kernel, plain version,
   library call and the bound;
4. the main path: Algorithm 1 (``FullRetrievalEngine`` on 400 queries,
   ``HasEngine`` on 1500) at d=768, h_max=5000, doc_cap=50,000, 8192 IVF
   buckets / nprobe 64, over 500,000 synthetic passages (100,000 entities);
   every kernel's launch count on that run must be > 0;
5. replay the first 300 HasEngine queries with ``backend="torch"`` on the
   same index: accept bits equal, ids equal up to near-ties;
6. the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Details of every phase are written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
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
SCORE_TOL = 1e-5               # f32 sums of 768 products in another order
K = 10
ENTITIES = 100_000             # 500,000 passages
HAS_QUERIES = 1500             # through HasEngine
FULL_QUERIES = 400             # through FullRetrievalEngine
REPLAY_QUERIES = 300           # replayed with backend="torch"
PROFILE_STEPS = 100            # fresh queries of the profiled window


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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def device_times(fn, reps: int, warm: bool = True) -> dict[str, float]:
    """Device time (us) per call of every kernel ``fn`` runs, by name, from
    ``torch.profiler`` (CUPTI).  Empty if the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / reps
    return out


def own_kernel_us(times: dict[str, float], names) -> float:
    """Summed device time of the kernels whose name contains one of
    ``names`` (the hand-written ones; not torch's allocations or fills)."""
    return sum(t for k, t in times.items() if any(n in k for n in names))


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

def check_kernels(dev, timer) -> dict:
    from repro_torch.kernels.homology_score import (homology_score,
                                                    homology_score_plain)
    from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
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

    for b in (1, 64):
        topk_case(f"B={b},N=50000", unit(b), ring, valid)
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
    for b, q in ((1, q1), (64, q64)):
        n_bytes = q.numel() * 4 + ring.numel() * 4 + valid.numel() \
            + b * K * 8
        bms, by = bound(n_bytes, 2 * b * ring.numel())
        rec[f"B={b}"] = {
            "ms": timer(lambda: topk_search(q, ring, K, valid)),
            "plain_ms": timer(lambda: topk_search_plain(q, ring, K, valid)),
            "library_ms": timer(lambda: torch.topk(q @ ring.T, K)),
            "bound_ms": bms, "bound_by": by,
            "kernel_device_us": own_kernel_us(device_times(
                lambda: topk_search(q, ring, K, valid), 20),
                ("topk_chunk_kernel", "topk_merge_kernel"))}
    del ring

    # -- ivf_scan: the fuzzy channel's probed-bucket scan ------------------
    rec = res["ivf_scan"] = {"cases": {}, "max_abs_err": 0.0, "swaps": 0}
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

    def ivf_case(name, q, probe, vecs, ids):
        kv, ki = ivf_scan(q, probe, vecs, ids, K)
        pv, pi = ivf_scan_plain(q, probe, vecs, ids, K)

        def score_of(r, gid):               # global ids are unique here
            slot = int((ids.view(-1) == gid).nonzero()[0, 0])
            if not (probe[r] == slot // ids.shape[1]).any():
                return -float("inf")        # not in a probed bucket
            return float(q[r] @ vecs.view(-1, d)[slot])

        err, sw = compare_topk(f"ivf_scan/{name}", kv, ki, pv, pi, score_of)
        rec["cases"][name] = {"max_abs_err": err, "swaps": sw}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["swaps"] += sw

    pr1, pr64 = probes(1, 64), probes(64, 64)
    ivf_case("B=1,P=64", q1, pr1, bvecs, bids)
    ivf_case("B=64,P=64", q64, pr64, bvecs, bids)
    ivf_case("pool < k (P=1, cap 4)", unit(3), probes(3, 1),
             bvecs[:, :4].contiguous(), bids[:, :4].contiguous())
    for b, q, pr in ((1, q1, pr1), (64, q64, pr64)):
        uniq = int(torch.unique(pr).numel())
        n_bytes = q.numel() * 4 + pr.numel() * 4 + uniq * cap * (d + 1) * 4 \
            + b * K * 8
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
            "kernel_device_us": own_kernel_us(device_times(
                lambda: ivf_scan(q, pr, bvecs, bids, K), 20),
                ("ivf_bucket_kernel", "topk_merge_kernel"))}
    del bvecs, bids

    # -- homology_score: validation against the query cache ---------------
    rec = res["homology_score"] = {"cases": {}, "max_abs_err": 0.0}
    h = 5000
    cache = torch.randint(-1, 2000, (h, K), device=dev, generator=g,
                          dtype=torch.int32)
    cvalid = torch.rand(h, device=dev, generator=g) < 0.8

    def drafts(b):
        x = torch.randint(-1, 2000, (b, K), device=dev, generator=g,
                          dtype=torch.int32)
        x[: b // 2 + 1, :3] = cache[: b // 2 + 1, :3]   # real overlaps
        return x

    def hom_case(name, draft, cache_, valid_, exact=True, **kw):
        ks = homology_score(draft, cache_, valid_, **kw)
        ps = homology_score_plain(draft, cache_, valid_, **kw)
        err = float_err(ks, ps, f"homology_score/{name}")
        if (exact and not torch.equal(ks, ps)) or err > 1e-6:
            raise AssertionError(f"homology_score/{name}: error {err}")
        rec["cases"][name] = {"max_abs_err": err}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    d1, d64 = drafts(1), drafts(64)
    hom_case("B=1,H=5000", d1, cache, cvalid)
    hom_case("B=64,H=5000", d64, cache, cvalid)
    hom_case("empty cache", d64, cache,
             torch.zeros(h, dtype=torch.bool, device=dev))
    w = torch.rand(64, K, device=dev, generator=g)
    hom_case("draft_weights", d64, cache, cvalid, exact=False,
             draft_weights=w / w.sum(1, keepdim=True))
    hom_case("groups", d64, cache, cvalid,
             row_group=(torch.arange(h, device=dev) % 4).int(),
             q_group=(torch.arange(64, device=dev) % 4).int())
    for b, dr in ((1, d1), (64, d64)):
        n_bytes = dr.numel() * 4 + cache.numel() * 4 + h + b * h * 4
        bms, by = bound(n_bytes, b * h * K * K)
        rec[f"B={b}"] = {
            "ms": timer(lambda: homology_score(dr, cache, cvalid)),
            "plain_ms": timer(lambda: homology_score_plain(dr, cache,
                                                           cvalid)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "kernel_device_us": own_kernel_us(device_times(
                lambda: homology_score(dr, cache, cvalid), 20),
                ("homology_kernel",))}
    return res


# ---------------------------------------------------------------------------
# Phases 4-5: the main path and its plain replay
# ---------------------------------------------------------------------------

def recording(engine):
    """Keep every (ids, accept, latency, homology) that ``step`` returns."""
    out, step = [], engine.step

    def rec(q_emb):
        r = step(q_emb)
        out.append(r)
        return r

    engine.step = rec
    return out


def main_path(dev, kernel_fns) -> dict:
    from repro_torch.core.has import HasConfig
    from repro_torch.data.synthetic import DATASETS, SyntheticWorld, \
        WorldConfig
    from repro_torch.retrieval.ivf import build_ivf
    from repro_torch.retrieval.service import RetrievalService
    from repro_torch.serving.engine import FullRetrievalEngine, HasEngine
    from repro_torch.serving.latency import LatencyModel

    info = {}
    t0 = time.perf_counter()
    world = SyntheticWorld(WorldConfig(n_entities=ENTITIES, d=768))
    info["world_build_s"] = time.perf_counter() - t0
    info["n_docs"] = world.cfg.n_docs
    ds = DATASETS["granola"]
    queries = world.sample_queries(HAS_QUERIES, pattern=ds["pattern"],
                                   zipf_a=ds["zipf_a"],
                                   p_uncovered=ds["p_uncovered"], seed=1)
    log(f"world: {world.cfg.n_docs} passages, d=768, built in "
        f"{info['world_build_s']:.1f} s")

    service = RetrievalService(world, LatencyModel(), k=K)
    full = FullRetrievalEngine(service).serve(queries[:FULL_QUERIES])
    info["full"] = full.summary()

    cfg = HasConfig(k=K, tau=0.2, h_max=5000, doc_capacity=50_000,
                    nprobe=64, n_buckets=8192, d=768)
    t0 = time.perf_counter()
    index = build_ivf(service.corpus, cfg.n_buckets, seed=0)
    torch.cuda.synchronize()
    info["ivf_build_s"] = time.perf_counter() - t0
    info["ivf_capacity"] = index.capacity
    has = HasEngine(service, cfg, index=index)
    steps = recording(has)
    for fn in kernel_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    res = has.serve(queries)
    info["has_serve_s"] = time.perf_counter() - t0
    info["launches"] = {fn.__name__: fn.launches for fn in kernel_fns}
    info["has"] = res.summary()
    for name, n in info["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    for ids, _, lat, hom in steps:
        if ids.shape != (K,) or not np.isfinite(lat) or not 0 <= hom <= 1:
            raise AssertionError("main path: malformed step output")
    s = info["has"]
    if not (0 < s["dar"] < 1 and 0 < s["doc_hit_rate"] <= 1):
        raise AssertionError(f"main path: implausible metrics {s}")

    # where the time goes: a fresh window of queries on the warm engine,
    # run once on the host clock, then again from the same cache snapshot
    # under the profiler (device time per kernel)
    window = world.sample_queries(PROFILE_STEPS, pattern=ds["pattern"],
                                  zipf_a=ds["zipf_a"],
                                  p_uncovered=ds["p_uncovered"], seed=2)
    snap = dataclasses.replace(has.state, **{
        f.name: getattr(has.state, f.name).clone()
        for f in dataclasses.fields(has.state)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accepted = sum(has.step(q["emb"])[1] for q in window)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / len(window)
    has.state = snap
    times = device_times(lambda: [has.step(q["emb"]) for q in window], 1,
                         warm=False)
    busy = sum(times.values()) / len(window)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    info["profile"] = {
        "steps": len(window), "accepted": int(accepted),
        "wall_us_per_step": wall_us, "device_busy_us_per_step": busy,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_us_per_step": {k[:90]: v / len(window) for k, v in top}}
    del steps[HAS_QUERIES:]             # drop the profiled window's steps

    # phase 5: the same queries through the plain backend, same index
    replay = HasEngine(service, cfg, backend="torch", index=index)
    plain_steps = recording(replay)
    replay.serve(queries[:REPLAY_QUERIES])
    swaps = 0
    for i, (a, b) in enumerate(zip(steps, plain_steps)):
        if a[1] != b[1]:
            raise AssertionError(f"replay: accept differs at query {i}")
        diff = np.flatnonzero(a[0] != b[0])
        if len(diff):
            q = torch.as_tensor(queries[i]["emb"], device=dev)
            sa = service.corpus[torch.as_tensor(a[0][diff]).long().to(dev)] @ q
            sb = service.corpus[torch.as_tensor(b[0][diff]).long().to(dev)] @ q
            if (a[0][diff] < 0).any() or (b[0][diff] < 0).any() or \
                    float((sa - sb).abs().max()) > SCORE_TOL:
                raise AssertionError(f"replay: ids differ at query {i}")
            swaps += len(diff)
    info["replay"] = {"queries": len(plain_steps), "accept_equal": True,
                      "near_tie_swaps": swaps,
                      "dar_plain": float(np.mean([s[1] for s in
                                                  plain_steps]))}
    return info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.homology_score import homology_score
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.kernels.topk_search import topk_search

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

    # phase 2: build
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s: "
        f"{sorted(p.name for p in paths.values())}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3: kernels against their plain versions
    timer = Timer(dev)
    kres = check_kernels(dev, timer)
    log(f"tolerance vs plain: scores within {SCORE_TOL} (f32 sums in "
        f"another order), ids equal except swaps of candidates whose "
        f"scores lie within it; unweighted homology bit-equal, weighted "
        f"within 1e-6")
    for name, r in kres.items():
        for b in (1, 64):
            t = r[f"B={b}"]
            lib = "n/a" if t["library_ms"] is None \
                else f"{t['library_ms']:.4f}"
            log(f"{name} B={b}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {lib} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernels alone "
                f"{t['kernel_device_us']:.1f} us (profiler); max_abs_err "
                f"{r['max_abs_err']:.3g}, near-tie swaps "
                f"{r.get('swaps', 0)}")
    torch.cuda.empty_cache()

    # phases 4-5
    info = main_path(dev, (topk_search, ivf_scan, homology_score))
    f, s = info["full"], info["has"]
    log(f"full: AvgL {f['avg_latency_s']:.4f} s, DocHit "
        f"{f['doc_hit_rate']:.4f}, RA {f['ra_qwen3-8b']:.4f}")
    log(f"HaS: AvgL {s['avg_latency_s']:.4f} s, DAR {s['dar']:.4f}, CAR "
        f"{s['car']:.4f}, DocHit {s['doc_hit_rate']:.4f}, RA "
        f"{s['ra_qwen3-8b']:.4f}; {HAS_QUERIES} queries in "
        f"{info['has_serve_s']:.1f} s")
    log(f"launches on the main path: {info['launches']}")
    pr = info["profile"]
    log(f"window of {pr['steps']} fresh queries ({pr['accepted']} "
        f"accepted): {pr['wall_us_per_step']:.1f} us/step wall, device busy "
        f"{pr['device_busy_us_per_step']:.1f} us/step (profiler), idle "
        f"share {pr['device_idle_share']:.3f}; top kernels us/step: "
        f"{json.dumps(pr['top_kernels_us_per_step'])}")
    log(f"replay ({info['replay']['queries']} queries, backend=torch): "
        f"accept bits equal, near-tie id swaps "
        f"{info['replay']['near_tie_swaps']}")

    sources = {"topk_search": ("src/repro_torch/kernels/csrc/topk_search.cu",
                               "src/repro/kernels/topk_search.py:25"),
               "ivf_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                            "src/repro/kernels/ivf_scan.py:19"),
               "homology_score": (
                   "src/repro_torch/kernels/csrc/homology_score.cu",
                   "src/repro/kernels/homology_score.py:17")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = kres[name]["B=1"]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": info["launches"][name],
                        "max_abs_err": kres[name]["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "tf32": tf32, "build_s": build_s, "build_log": _build.build_log,
         "kernels": kres, "main_path": info,
         "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
