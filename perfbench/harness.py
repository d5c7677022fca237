"""Run one cell of the benchmark once.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``, found through its entry's
``file``) and a traffic mix (``traffic/<traffic>.json``).  The cloud stage
is the module ``stages/<cloud.kind>.py``, and each per-layer metric the
reader ``metrics/<name>.py``.  Nothing here names a cell, a configuration,
a mix or a metric.

A run: the world and the stream from the seed; the program's set-up
through its public constructors (``RetrievalService`` over the stage's
backend, ``build_ivf``, ``BatchedHasEngine(index=...)``); the cell's own
stream served until ``fill_rejects`` rejects have been folded into the
cache; then the window: micro-batches of ``batch`` queries in a closed
loop, each admitted when the last returns, for ``seconds`` seconds and to
the end of the step that crosses them.  A traced run serves ``TRACE_STEPS``
more micro-batches under the profiler.  Then the program's indexes are
freed and the reference judges the run (``reference/judge.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import roofline
from perfbench.reference import has as ref_has
from perfbench.reference import index as ref_index
from perfbench.reference import judge, search
from perfbench.traffic import generator

TRACE_STEPS = 16       # micro-batches under the profiler in a traced run
JUDGE_STEPS = 16       # window micro-batches the reference judges
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_module(path: Path, prefix: str):
    """The module in file ``path``, loaded once a process under a name
    made from ``prefix`` and the file's stem."""
    name = prefix + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def pin_thread():
    """Keep this thread, which launches every micro-batch, on one core (the
    highest it may use) for the fill and the window -> the mask it had, or
    None where the platform has no affinity.  A host-paced step's speed
    follows the core its launching thread lands on, and a thread left free
    to land anywhere makes runs on one machine read as two populations."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    mask = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(mask)})
    return mask


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.pkg = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def stage(self, kind: str):
        return load_module(self.pkg / "stages" / f"{kind}.py",
                           "perfbench_stage_")

    def reader(self, metric: str):
        return load_module(self.pkg / "metrics" / f"{metric}.py",
                           "perfbench_metric_").read

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class StepLog:
    first: int                  # stream index of the first query
    t_admit: float
    t_done: float
    accept: np.ndarray          # [B] bool
    served: np.ndarray          # [B, k] int32
    answered: int
    val_ids: object             # [B, k] tensor of the program's drafts
    phase: str


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cell: dict
    config: dict
    traffic: dict
    window: list                # StepLog of the window's micro-batches
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: object = None        # trace.TraceSummary
    work: dict | None = None    # least seconds by operation: window, trace


class Driver:
    """Serves the stream, one micro-batch a call, through
    ``BatchedHasEngine._step_batch``, and keeps each step's answers and the
    program's drafts (``speculate_batch``'s ``val_ids``)."""

    def __init__(self, engine, stream, batch: int, k: int, device):
        self.engine, self.stream = engine, stream
        self.batch, self.k, self.device = batch, k, device
        self.pos = 0
        self.logs: list[StepLog] = []
        self._drafts = None
        import repro_torch.serving.batched as batched
        self._batched = batched
        self._orig = batched.speculate_batch

        def capture(*a, **kw):
            out = self._orig(*a, **kw)
            self._drafts = out["val_ids"]
            return out
        batched.speculate_batch = capture

    def close(self):
        self._batched.speculate_batch = self._orig

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, phase: str) -> StepLog:
        b, first = self.batch, self.pos
        if first + b > len(self.stream.emb):
            raise RuntimeError(f"stream exhausted after {first} queries: "
                               f"raise the mix's max_qps or fill_queries")
        group = [{"emb": self.stream.emb[i]} for i in range(first, first + b)]
        self._drafts = None
        self.sync()
        t0 = time.perf_counter()
        results = self.engine._step_batch(group, None, None)
        self.sync()
        t1 = time.perf_counter()
        self.pos += b
        accept = np.zeros(b, bool)
        served = np.full((b, self.k), -1, np.int32)
        answered = 0
        for j, r in enumerate(results[:b]):
            ids = np.asarray(r[0]).reshape(-1)
            if ids.shape[0] == self.k:
                served[j] = ids
                accept[j] = bool(r[1])
                answered += 1
        log = StepLog(first, t0, t1, accept, served, answered, self._drafts,
                      phase)
        self.logs.append(log)
        return log


def build_program(cfg: dict, stage, corpus, seed: int, device):
    """The program under test, through its public constructors."""
    from repro_torch.core.has import HasConfig
    from repro_torch.retrieval.ivf import build_ivf
    from repro_torch.retrieval.service import RetrievalService
    from repro_torch.serving.batched import BatchedHasEngine
    from repro_torch.serving.latency import LatencyModel
    lat = LatencyModel()
    world = SimpleNamespace(cfg=SimpleNamespace(d=int(cfg["d"]),
                                                n_docs=corpus.shape[0]),
                            doc_emb=corpus)
    backend = stage.build_port(corpus, cfg, seed, device, lat)
    service = RetrievalService(world, lat, k=int(cfg["k"]),
                               chunk=int(cfg["cloud"].get("chunk", 32768)),
                               backend=backend, device=device)
    hc = HasConfig(k=int(cfg["k"]), tau=float(cfg["tau"]),
                   h_max=int(cfg["h_max"]), doc_capacity=int(cfg["doc_cap"]),
                   nprobe=int(cfg["nprobe"]), n_buckets=int(cfg["n_buckets"]),
                   d=int(cfg["d"]))
    # k-means under deterministic algorithms (its sums in row order), so
    # that the reference can work the same buckets out again
    with ref_index.deterministic():
        fuzzy = build_ivf(corpus, hc.n_buckets,
                          capacity_factor=float(cfg["capacity_factor"]),
                          kmeans_iters=int(cfg["kmeans_iters"]),
                          seed=generator.subseed(seed, "fuzzy"),
                          device=device)
    engine = BatchedHasEngine(service, hc, batch_size=int(cfg["batch"]),
                              seed=seed, index=fuzzy)
    return engine, service, int(fuzzy.bucket_counts.sum())


def _queries(stream, first, n, device):
    return torch.as_tensor(stream.emb[first:first + n], device=device)


def replay(cfg, stage, sref, fuzzy, stream, logs, judged, with_work):
    """Fold every served cloud result into the reference's rings, in order.
    -> (the final rings, [(log, its rings before)] of the ``judged`` logs,
    the least seconds of each operation of the window's and the traced
    steps, or None)."""
    k, d, nprobe = int(cfg["k"]), int(cfg["d"]), int(cfg["nprobe"])
    rings = ref_has.Rings.empty(int(cfg["h_max"]), k, int(cfg["doc_cap"]))
    counts = fuzzy.counts.cpu().numpy()
    before, work = [], {"window": {}, "trace": {}}
    for log in logs:
        if id(log) in judged:
            before.append((log, rings.copy()))
        held, d_ptr = int((rings.doc_ids >= 0).sum()), rings.d_ptr
        rej = np.flatnonzero(~log.accept)
        for i in rej:
            rings.fold(log.first + int(i), log.served[i])
        if not with_work or log.phase not in work:
            continue
        b = len(log.accept)
        q = _queries(stream, log.first, b, fuzzy.centroids.device)
        p, _ = ref_index.probe(fuzzy, q, nprobe)
        ops = {"cache_topk": roofline.cache_topk(b, held, d, k),
               "fuzzy_probe": roofline.probe_product(b, fuzzy.n_buckets, d,
                                                     nprobe),
               "fuzzy_scan": roofline.bucket_scan(p.cpu().numpy(), counts, d,
                                                  k, 4.0 * d + 4.0),
               "validate": roofline.homology(b, int(cfg["h_max"]), k),
               "ingest": roofline.ingest(len(rej), rings.d_ptr - d_ptr, k, d,
                                         int(cfg["doc_cap"]))}
        ops.update(stage.work(sref, cfg, q[torch.as_tensor(
            rej, dtype=torch.long, device=q.device)]))
        ops["step"] = sum(ops.values())
        for name, t in ops.items():
            work[log.phase][name] = work[log.phase].get(name, 0.0) + t
    return rings, before, (work if with_work else None)


def judge_drafts(cfg, corpus, fuzzy, stream, before, control):
    """Each judged micro-batch's drafts and accept bits against its rings
    and its probed buckets -> (draft_gap, accept_miss, the control's
    draft_gap or None, [(reject queries, their served ids)])."""
    dev, n = corpus.device, corpus.shape[0]
    k, tau, nprobe = int(cfg["k"]), float(cfg["tau"]), int(cfg["nprobe"])
    gap, miss, ctl, rejects = 0.0, 0, 0.0, []
    for log, rb in before:
        b = len(log.accept)
        q = _queries(stream, log.first, b, dev)
        strict, lenient = ref_index.probe_masks(fuzzy, q, nprobe)
        mask, _ = judge.draft_eligible(rb, fuzzy, strict, n, dev)
        _, at = judge.draft_eligible(rb, fuzzy, lenient, n, dev)
        with search.precision_scope("f64") as dt:
            vals, _ = search.blocked_topk(search.exact_block(q, corpus, dt),
                                          mask, n, b, k, dev)
        rows = search.exact_rows(q, corpus)
        drafts = (torch.full((b, k), -1, device=dev) if log.val_ids is None
                  else log.val_ids.to(dev)).long()
        served = torch.as_tensor(log.served, device=dev).long()
        acc = torch.as_tensor(log.accept, device=dev)
        # the drafts validated, and the answers served from them
        answers = torch.where(acc[:, None], served, drafts)
        gap = max(gap, judge.draft_reading(vals, drafts, rows, at),
                  judge.draft_reading(vals, answers, rows, at))
        miss += judge.accept_misses(drafts, acc, rb, tau)
        if control:
            with search.precision_scope("tf32") as dt:
                _, c_ids = search.blocked_topk(
                    search.exact_block(q, corpus, dt), mask, n, b, k, dev)
            ctl = max(ctl, judge.draft_reading(vals, c_ids, rows, at))
        if bool((~acc).any()):
            rejects.append((q[~acc], served[~acc]))
    return gap, miss, (ctl if control else None), rejects


def judge_cloud(stage, sref, corpus, rejects, k, control):
    """The judged rejects' cloud ids against the stage's reference ->
    (cloud_gap, the control's cloud_gap or None)."""
    if not rejects:
        return 0.0, (0.0 if control else None)
    steps = [q for q, _ in rejects]
    ids = torch.cat([i for _, i in rejects])
    vals, _ = stage.select(sref, corpus, steps, k, "f64")
    gap = judge.gap(vals, ids, stage.rescore(sref, corpus, steps, ids))
    if not control:
        return gap, None
    _, c_ids = stage.select(sref, corpus, steps, k, "tf32")
    return gap, judge.gap(vals, c_ids, stage.rescore(sref, corpus, steps,
                                                     c_ids))


def judge_run(cfg, stage, corpus, stream, logs, window, state, seed,
              control: bool = False, with_work: bool = False):
    """The reference's readings of a run (and of the control in its place
    when ``control``), and the least seconds of each operation of the
    window's and the traced steps (``with_work``)."""
    rng = np.random.default_rng(generator.subseed(seed, "judge"))
    picks = rng.choice(len(window), size=min(JUDGE_STEPS, len(window)),
                       replace=False)
    judged = {id(window[i]) for i in picks.tolist()}
    fuzzy = ref_index.build(corpus, int(cfg["n_buckets"]),
                            float(cfg["capacity_factor"]),
                            generator.subseed(seed, "fuzzy"),
                            int(cfg["kmeans_sample"]),
                            int(cfg["kmeans_iters"]))
    sref = stage.reference(corpus, cfg, seed)
    rings, before, work = replay(cfg, stage, sref, fuzzy, stream, logs,
                                 judged, with_work)
    d_gap, a_miss, d_ctl, rejects = judge_drafts(cfg, corpus, fuzzy, stream,
                                                 before, control)
    c_gap, c_ctl = judge_cloud(stage, sref, corpus, rejects, int(cfg["k"]),
                               control)
    readings = {"draft_gap": d_gap, "cloud_gap": c_gap,
                "accept_miss": a_miss,
                "state_miss": judge.state_misses(state, rings, stream.emb,
                                                 corpus),
                "unanswered": sum(len(w.accept) - w.answered
                                  for w in window)}
    ctl = {"draft_gap": d_ctl, "cloud_gap": c_ctl} if control else None
    return readings, ctl, work


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", control: bool = False,
             t_start: float | None = None) -> dict:
    """One run of cell ``name``: the result line's fields, and under
    ``"checks"`` each number compared beside its limit."""
    t_start = process_start() if t_start is None else t_start
    cell = bench.cell(name)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    stage = bench.stage(cfg["cloud"]["kind"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if int(mix["batch"]) != int(cfg["batch"]):
        raise ValueError("the mix's batch and the configuration's differ")
    if int(cfg["corpus_rows"]) != (int(cfg["world"]["n_entities"])
                                   * int(cfg["world"]["docs_per_entity"])):
        raise ValueError("corpus_rows is not n_entities x docs_per_entity")
    phases = {}

    def mark(name):
        phases[name] = time.time() - t_start
    mark("start")
    world = generator.make_world(cfg, seed, dev)
    n_stream = generator.stream_length(mix, seconds,
                                       TRACE_STEPS if trace else 0)
    stream = generator.make_stream(world, cfg, mix, seed, n_stream)
    corpus = world.corpus
    del world
    mark("world")
    engine, service, kept = build_program(cfg, stage, corpus, seed, dev)
    mark("program")
    drv = Driver(engine, stream, int(cfg["batch"]), int(cfg["k"]), dev)
    affinity = pin_thread()
    try:
        rejects = 0
        while rejects < int(mix["fill_rejects"]):
            if drv.pos + drv.batch > int(mix["fill_queries"]):
                raise RuntimeError("the fill did not reach fill_rejects "
                                   "within fill_queries")
            log = drv.step("fill")
            rejects += int((~log.accept).sum())
        setup_s = time.time() - t_start
        mark("fill")
        window = []
        t0 = time.perf_counter()
        while not window or window[-1].t_done - t0 < seconds:
            window.append(drv.step("window"))
        window_s = window[-1].t_done - window[0].t_admit
        summary = None
        if trace:
            from perfbench import trace as tr
            summary = tr.profile_steps(lambda: drv.step("trace"),
                                       TRACE_STEPS, service)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    finally:
        drv.close()
        if affinity is not None:
            os.sched_setaffinity(0, affinity)
    state = engine.state
    logs = drv.logs
    del engine, service, drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mark("window")
    readings, ctl, work = judge_run(cfg, stage, corpus, stream, logs, window,
                                    state, seed, control=control,
                                    with_work=trace)
    mark("reference")
    limits = {key: float(cfg["limits"][key]) for key in
              ("draft_gap", "cloud_gap")}
    limits.update({key: 0.0 for key in judge.EXACT_LIMITS})
    correct = all(readings[key] <= limits[key] for key in limits)
    attempted = sum(len(w.accept) for w in window)
    rec = RunRecord(cell=cell, config=cfg, traffic=mix, window=window,
                    window_s=window_s, setup_s=setup_s, peak_bytes=int(peak),
                    trace=summary, work=work)
    metrics = {}
    for m in bench.metrics(name, trace):
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(readings["unanswered"]), "metrics": metrics,
           "device": device_info(dev, peak, summary)}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["info"] = dict(run_info(window, window_s, phases), kept_rows=kept)
    if ctl is not None:
        out["control"] = {key: _num(v) for key, v in ctl.items()}
    out["checks"] = {key: {"value": _num(readings[key]),
                           "limit": limits[key]} for key in limits}
    return out


def run_info(window, window_s, phases) -> dict:
    """What the driver does not read: the window's accept share, the
    set-up's phases (seconds from process start) and, by tenth of the
    window, the mean wall (ms) and rejects of a micro-batch."""
    n = sum(len(w.accept) for w in window)
    tenths = [window[i * len(window) // 10:(i + 1) * len(window) // 10]
              for i in range(10)]
    return {"steps": len(window),
            "accept_share": sum(int(w.accept.sum()) for w in window) / n,
            "window_s": window_s, "phases_s": phases,
            "tenths": [[1e3 * float(np.mean([w.t_done - w.t_admit
                                             for w in t])),
                        float(np.mean([(~w.accept).sum() for w in t]))]
                       for t in tenths if t]}


def _num(x):
    return x if math.isfinite(x) else "inf"


def device_info(dev, peak, summary) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
