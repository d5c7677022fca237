"""One-card dry run: every (arch x shape) cell's step, run once on ``meta``.

Twin of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell on a 512-device host mesh over ``ShapeDtypeStruct`` arguments;
here each cell's :class:`~repro_torch.configs.base.LoweringBundle` runs
once on the ``meta`` device, which gives every tensor a shape and a dtype
and no values: nothing is allocated and nothing launches, so the sweep
runs on a CPU box as on the card's host.  One card has no mesh, so
``mesh`` is ``"1"`` and ``n_devices`` 1.

A record's keys:

* ``flops_per_device``: the products ``torch.utils.flop_counter.
  FlopCounterMode`` counts over the call (matrix products, batched
  products, convolutions, attention), the backward and any recompute
  included.  It counts no elementwise work, no reductions and no
  ``index_add_`` / ``scatter`` (XLA's cost analysis counts those).  A
  hand-written kernel on the path is counted by its own formula through
  ``custom_mapping``: the decode cells reach ``decode_attention``, whose
  meta form is ``decode_attention_abstract``, counted as ``4 B H D
  covered`` (``kernels/decode_attention.py::decode_attention_flops``); the
  eight kernels' launch counters stay 0.
* ``flops_by_dtype``: the same products by the dtype of their first
  operand (``bfloat16`` runs on the tensor cores' bf16 peak, ``float32``
  on the f32 peak: the port keeps TF32 off).
* ``bytes_per_device``: the sum of each operation's input and output bytes
  (views excluded), the eager counterpart of XLA's "bytes accessed": the
  port's unfused traffic.  A gather (``embedding``, ``index``,
  ``index_select``, ``gather``) reads its source at the gathered rows
  only, an overwriting in-place operation (``copy_``, ``fill_``,
  ``zero_``, ``index_put_``) does not read what it writes, and the kernel
  reads what ``decode_attention_reads`` says.  It is not a bound.
* ``argument_size_in_bytes`` / ``output_size_in_bytes``: the bytes of the
  call's arguments and of what it returns (each tensor once).  A train
  step updates its parameters and state in place and returns them, so its
  output holds them as the reference's donated outputs do.
* ``argument_read_bytes`` / ``output_written_bytes``: the bytes the call
  must move, for the roofline's bound: what it reads of the arguments
  (by the rules above; each byte at most once: an embedding table that is
  only gathered from counts its gathered rows, an argument never read
  counts nothing), and what it writes: its new outputs, and the bytes
  written in place into the arguments, each at most once (a decode step
  writes one position of the KV cache it returns; an optimizer step
  rewrites every parameter and moment).  The dry run has no values, so a
  row gathered twice counts twice.
* ``temp_size_in_bytes``: the peak, over the call, of the bytes of live
  storages that are not the arguments': each storage an operation creates
  counts from its creation until it is freed (a ``weakref.finalize`` on
  the storage fires when the last tensor, saved tensors of the autograd
  graph included, lets it go).  It is a peak, not a sum.
* ``fits_one_card``: arguments + temp within ``CARD_MEMORY_BYTES``.
* ``collectives``: the reference's per-collective byte and op counts, all
  0 on one card.

Left out: ``--multi-pod`` and ``--both-meshes`` (one card, one mesh),
``--probe`` (the reference's unrolled 1- and 2-layer lowerings correct its
cost analysis, which counts a scanned body once; the counter here counts
every layer), ``rules_for_mesh`` (JAX mesh rules), ``collective_bytes``
(it parses XLA's HLO text) and ``compile_s`` / ``hlo_ops`` (no compiler).

Usage:
  python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out dryrun.json] [--skip-done]
      [--jobs N]    (N processes, a cell each at a time)
"""
from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import multiprocessing
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_archs, get_arch
from repro_torch.kernels import decode_attention as da

CARD_MEMORY_BYTES = 80e9       # NVIDIA H100 80GB HBM3 (data sheet: 80 GB)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the hand-written kernels a path reaches on meta, by their own work
_DECODE = torch.ops.repro_torch.decode_attention
KERNEL_FLOPS = {_DECODE: da.decode_attention_flops}
KERNEL_READS = {_DECODE: da.decode_attention_reads}

_aten = torch.ops.aten
# a gather reads its source (argument 0) at the gathered rows only: as many
# bytes as it writes
GATHERS = {_aten.embedding, _aten.index, _aten.index_select, _aten.gather}
# in-place operations that overwrite what they write without reading it
OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.index_put_,
              _aten._index_put_impl_}


def tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_nbytes(tree) -> int:
    """The bytes of the tensors in ``tree``, each tensor once."""
    seen = {id(t): t for t in tensors(tree)}
    return sum(map(nbytes, seen.values()))


def _key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _written(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors ``func`` writes in place (its schema's mutable
    arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
    return out


def _reads(func, args, kwargs, out) -> list[tuple[torch.Tensor, int]]:
    """(input, the bytes ``func`` reads of it): the whole view, but a
    gather's rows, the kernels' own counts, and nothing of what an
    overwriting operation writes."""
    packet = func.overloadpacket
    ins = tensors((args, kwargs))
    if packet in KERNEL_READS:
        return list(zip(ins, KERNEL_READS[packet](*args, **kwargs)))
    skip = [id(t) for t in _written(func, args, kwargs)] \
        if packet in OVERWRITES else []
    reads = []
    for j, t in enumerate(ins):
        if j == 0 and packet in GATHERS:
            reads.append((t, tree_nbytes(out)))
        elif id(t) not in skip:
            reads.append((t, nbytes(t)))
    return reads


class _Tally(TorchDispatchMode):
    """Products by dtype, traffic, the bytes read of and written into the
    arguments' storages, and the peak of live storages created during the
    call (the arguments' excluded)."""

    def __init__(self, registry: dict, args):
        super().__init__()
        self.registry = registry
        self.flops: dict[str, int] = defaultdict(int)
        self.traffic = 0
        self.live = self.peak = 0
        # the arguments' storages -> their bytes, and what was read of them
        # and written into them
        self.args = {_key(t): t.untyped_storage().nbytes()
                     for t in tensors(args)}
        self.read: dict = defaultdict(int)
        self.wrote: dict = defaultdict(int)
        # storage -> its bytes while live; the arguments' count as 0
        self.known = dict.fromkeys(self.args, 0)

    def _track(self, t: torch.Tensor) -> None:
        st, key = t.untyped_storage(), _key(t)
        if key in self.known:
            return
        self.known[key] = n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self.known.pop(key)

    def arguments_read(self) -> int:
        """Bytes read of the arguments, each byte at most once."""
        return sum(min(n, self.args[k]) for k, n in self.read.items())

    def arguments_written(self) -> int:
        """Bytes written into the arguments, each byte at most once."""
        return sum(min(n, self.args[k]) for k, n in self.wrote.items())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        outs = tensors(out)
        if packet in self.registry:
            n = self.registry[packet](*args, **kwargs, out_val=out)
            first = tensors((args, kwargs))[0]
            self.flops[str(first.dtype).removeprefix("torch.")] += n
        if not func.is_view:
            reads = _reads(func, args, kwargs, out)
            self.traffic += sum(n for _, n in reads) + sum(map(nbytes, outs))
            for t, n in reads:
                if _key(t) in self.args:
                    self.read[_key(t)] += n
            for t in _written(func, args, kwargs):
                if _key(t) in self.args:
                    values = args[2] if packet in (
                        _aten.index_put_, _aten._index_put_impl_) else t
                    self.wrote[_key(t)] += nbytes(values)
        for t in outs:
            self._track(t)
        return out


def count(fn, args) -> dict:
    """Run ``fn(*args)`` once (``meta`` arguments) under the counters ->
    the record's counted keys."""
    gc.collect()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False, custom_mapping=KERNEL_FLOPS) as fc:
        with _Tally(fc.flop_registry, args) as tally:
            out = fn(*args)
    seconds = time.perf_counter() - t0
    fresh = {id(t): t for t in tensors(out) if _key(t) not in tally.args}
    rec = {"lower_s": round(seconds, 2),
           "flops_per_device": float(fc.get_total_flops()),
           "flops_by_dtype": dict(tally.flops),
           "bytes_per_device": float(tally.traffic),
           "argument_size_in_bytes": tree_nbytes(args),
           "output_size_in_bytes": tree_nbytes(out),
           "argument_read_bytes": tally.arguments_read(),
           "output_written_bytes": tree_nbytes(list(fresh.values()))
           + tally.arguments_written(),
           "temp_size_in_bytes": tally.peak}
    if sum(tally.flops.values()) != fc.get_total_flops():
        raise AssertionError(f"flops by dtype {dict(tally.flops)} against "
                             f"{fc.get_total_flops()}")
    return rec


def run_cell(arch: str, shape: str, **variant) -> dict:
    """One cell's record (module docstring); a failure is recorded with
    its error and traceback, and the sweep carries on."""
    rec = {"arch": arch, "shape": shape, "mesh": "1", "n_devices": 1,
           "ok": False}
    if variant:
        rec["variant"] = dict(variant)
    try:
        bundle = get_arch(arch).make_bundle(shape, **variant)
        rec.update(count(bundle.fn, bundle.abstract_args))
        rec["fits_one_card"] = (rec["argument_size_in_bytes"]
                                + rec["temp_size_in_bytes"]
                                <= CARD_MEMORY_BYTES)
        rec["collectives"] = {**{c: 0 for c in COLLECTIVES},
                              **{f"n_{c}": 0 for c in COLLECTIVES},
                              "total": 0}
        rec["ok"] = True
        print(f"[dryrun] OK  {arch:18s} {shape:14s} "
              f"{rec['lower_s']}s flops={rec['flops_per_device']:.3e} "
              f"args={rec['argument_size_in_bytes'] / 1e9:.2f}GB "
              f"temp={rec['temp_size_in_bytes'] / 1e9:.2f}GB "
              f"fits={rec['fits_one_card']}", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] FAIL {arch} {shape}: {rec['error']}", flush=True)
    return rec


def cell_key(r: dict) -> tuple:
    return (r["arch"], r["shape"],
            json.dumps(r.get("variant") or {}, sort_keys=True))


def _records(cells: list, jobs: int):
    """Each cell's record, as it ends, from ``jobs`` processes."""
    if jobs <= 1 or not cells:
        yield from (run_cell(a, s) for a, s in cells)
        return
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        futures = [pool.submit(run_cell, a, s) for a, s in cells]
        for f in concurrent.futures.as_completed(futures):
            yield f.result()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already OK in --out")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes running cells side by side")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in all_archs()
                 for shape in get_arch(arch).shapes]
    else:
        cells = [(args.arch, args.shape)]

    results, done = [], set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        if args.skip_done:
            done = {cell_key(r) for r in results if r.get("ok")}

    for rec in _records([c for c in cells if (*c, "{}") not in done],
                        args.jobs):
        results = [r for r in results if cell_key(r) != cell_key(rec)]
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK")


if __name__ == "__main__":
    main()
