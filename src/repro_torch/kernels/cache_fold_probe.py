"""The fold's time at the serving shape, beside its bound and the row loop.

    PYTHONPATH=src python -m repro_torch.kernels.cache_fold_probe

Needs an NVIDIA card and nvcc.  The shape is the HaS cell's: h_max 5000,
doc_cap 50,000, k 10, d 768, chunks of 64 rows; the rings are filled (ids
drawn without repeats from a 6,150,140-row corpus, every pointer past its
first turn), and each chunk's ids are drawn half from the doc ring and half
from the corpus, so that the fold inserts about half of them.  For 20, 32
and 64 unmasked rows of a chunk it prints, as a JSON line (also written to
``chiprun_out/cache_fold_probe.json``):

- ``call_ms``: CUDA events around one ``cache_fold`` call, the L2 cache
  cleared and the rings restored before each (median of 50);
- ``device_ms``: the three kernels alone, from ``torch.profiler`` (mean
  of 50 calls), and each kernel's time;
- ``host_ms``: the call's host time (the enqueue; median of 50);
- ``chunk_host_ms``: ``cache_update_chunked``'s host time for the chunk
  from host rows, the one upload included;
- ``plain_ms``: ``cache_fold_plain``'s time (host clock to a synchronize);
- ``bound_ms``: the bytes the fold must move over 3.35 TB/s: the id ring
  read once, and each folded row and each inserted doc read and written
  once (ids, valid bits, pointers);
- ``inserted``: the docs the chunk inserted.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import has as H
from repro_torch.kernels import cache_fold as CF

CORPUS = 6_150_140
SHAPE = dict(k=10, h_max=5000, doc_capacity=50_000, d=768)
CHUNK = 64
PEAK_BYTES = 3.35e12
REPEAT = 50


def _state(cfg, rng, dev):
    st = H.init_has_state(cfg, device=dev)
    st.doc_ids.copy_(torch.from_numpy(
        rng.choice(CORPUS, cfg.doc_cap, replace=False).astype(np.int32)))
    st.query_doc_ids.copy_(torch.from_numpy(
        rng.integers(0, CORPUS, (cfg.h_max, cfg.k)).astype(np.int32)))
    st.query_valid.fill_(True)
    st.q_ptr.fill_(3 * cfg.h_max + 17)
    st.d_ptr.fill_(3 * cfg.doc_cap + 4321)
    return st


def _chunk(cfg, st, rng, rows):
    ring = st.doc_ids.cpu().numpy()
    ids = rng.integers(0, CORPUS, (CHUNK, cfg.k)).astype(np.int32)
    pick = rng.random((CHUNK, cfg.k)) < 0.5
    ids[pick] = rng.choice(ring, int(pick.sum()))
    q = rng.standard_normal((CHUNK, cfg.d), dtype=np.float32)
    mask = np.zeros(CHUNK, bool)
    mask[:rows] = True
    return q, ids, mask


def _bytes(cfg, rows, inserted):
    row = cfg.d * 4 + cfg.k * 4
    return (cfg.doc_cap * 4 + rows * (2 * row + 1)
            + inserted * 2 * (cfg.d * 4 + 4) + 16)


def measure(rows: int, dev, corpus, rng) -> dict:
    cfg = H.HasConfig(**SHAPE)
    st = _state(cfg, rng, dev)
    keep = {f.name: getattr(st, f.name).clone()
            for f in dataclasses.fields(st)
            if f.name not in ("doc_emb", "query_emb")}
    qn, idn, maskn = _chunk(cfg, st, rng, rows)
    q, ids, mask = (torch.from_numpy(x).to(dev) for x in (qn, idn, maskn))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def restore():
        for f, v in keep.items():
            getattr(st, f).copy_(v)

    def fold():
        CF.cache_fold(st, q, ids, None, corpus, mask)

    restore()
    fold()
    torch.cuda.synchronize()
    inserted = int(st.d_ptr) - int(keep["d_ptr"])
    calls, hosts = [], []
    for _ in range(REPEAT):
        restore()
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        fold()
        hosts.append(time.perf_counter() - t0)
        b.record()
        torch.cuda.synchronize()
        calls.append(a.elapsed_time(b))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)        # Kineto drops records at its window's edge
        for _ in range(REPEAT):
            restore()
            fold()
        torch.cuda.synchronize()
        time.sleep(0.02)
    per, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "fold_" in e.key:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            name = re.search(r"fold_\w+", e.key).group()
            per[name] = per.get(name, 0.0) + t / REPEAT / 1e3
            launches += e.count
    chunk_hosts = []
    for _ in range(REPEAT):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H.cache_update_chunked(cfg, st, qn[:rows], idn[:rows], corpus=corpus,
                               chunk=CHUNK)
        chunk_hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    plains = []
    for _ in range(5):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CF.cache_fold_plain(st, q, ids, None, corpus, mask)
        torch.cuda.synchronize()
        plains.append(time.perf_counter() - t0)
    med = statistics.median
    return {"rows": rows, "inserted": inserted,
            "call_ms": med(calls), "device_ms": sum(per.values()),
            "kernels_ms": dict(sorted(per.items())),
            "launches_a_call": launches / REPEAT,
            "host_ms": 1e3 * med(hosts),
            "chunk_host_ms": 1e3 * med(chunk_hosts),
            "plain_ms": 1e3 * med(plains),
            "bound_ms": 1e3 * _bytes(cfg, rows, inserted) / PEAK_BYTES}


def main() -> None:
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    rng = np.random.default_rng(0)
    # the corpus rows the fold reads by id; only their addresses matter
    corpus = torch.empty((CORPUS, SHAPE["d"]), dtype=torch.float32,
                         device=dev)
    out = {"card": card.strip(),
           "shapes": [measure(r, dev, corpus, rng) for r in (20, 32, 64)]}
    line = json.dumps(out)
    print(line)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/cache_fold_probe.json", "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
