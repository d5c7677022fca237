"""Dry run: every (arch x shape) cell's step, run once on ``meta``, on
one card or one rank of the production mesh.

Twin of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell on a 512-device host mesh over ``ShapeDtypeStruct`` arguments;
here each cell's :class:`~repro_torch.configs.base.LoweringBundle` runs
once on the ``meta`` device, which gives every tensor a shape and a dtype
and no values: nothing is allocated and nothing launches, so the sweep
runs on a CPU box as on the card's host.

One card (the default): ``mesh`` is ``"1"`` and ``n_devices`` 1.  With
``--multi-pod`` / ``--both-meshes`` (:func:`run_mesh_cell`) the cell runs
in a process holding a ``fake`` world of 256 ranks (16x16 ``(data,
model)``) or 512 (2x16x16 ``(pod, data, model)``; ``launch/mesh.py``):
its arguments are ``DTensor`` leaves on ``meta``, placed by the bundle's
``arg_logical`` under :func:`rules_for_mesh`, the step runs as rank 0
runs it, and the collectives move nothing.  Every count below is then
rank 0's: its local shards' products and bytes (an uneven shard leaves
the last rank short, so rank 0 holds the largest), and its collectives.

A record's keys:

* ``flops_per_device``: the products ``torch.utils.flop_counter``'s
  formulas count over the call (matrix products, batched products,
  convolutions, attention), the backward and any recompute included.  It
  counts no elementwise work, no reductions and no ``index_add_`` /
  ``scatter`` (XLA's cost analysis counts those).  A hand-written kernel
  on the path is counted by its own formula through ``custom_mapping``:
  the decode cells reach ``decode_attention``, whose meta form is
  ``decode_attention_abstract``, counted as ``4 B H D covered``
  (``kernels/decode_attention.py::decode_attention_flops``); the eight
  kernels' launch counters stay 0.  On a mesh the formulas are applied to
  each operation on rank 0's local tensors (a dispatch mode beneath
  ``DTensor``'s), not to the global product.
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
  call's arguments and of what it returns (each tensor once; rank 0's
  shards on a mesh).  A train step updates its parameters and state in
  place and returns them, so its output holds them as the reference's
  donated outputs do.
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
* ``fits_one_card`` (one card) / ``fits_each_card`` (a mesh): arguments +
  temp within ``CARD_MEMORY_BYTES``.
* ``collectives``: the reference's keys (:data:`COLLECTIVES`, their
  ``n_`` counts and ``total``): each collective rank 0 issues counts the
  bytes of its result, as the reference's ``collective_bytes`` counts the
  result shapes in the HLO (an all-gather its gathered tensor, a
  reduce-scatter its shard).  A redistribution from one sharded dim to
  another counts as the ``all-to-all`` NCCL would run, at its result's
  bytes, where the CPU's process group gathers and slices instead.  All 0
  on one card.
* ``sites`` (a mesh): rank 0's products and collective bytes by the line
  of the port that issued them (``models/layers.py:312``; the backward's
  at its ``backward()`` call).  ``DTensor``'s plan, and with it the
  collectives, products and temporaries of a rank, is the installed
  torch release's (``torch``, in every record): the same cell can read
  otherwise under another release, and ``sites`` shows where.

Left out: ``--probe`` (the reference's unrolled 1- and 2-layer lowerings
correct its cost analysis, which counts a scanned body once; the counter
here counts every layer), ``collective_bytes`` (it parses XLA's HLO text;
the collectives are counted as they are issued) and ``compile_s`` /
``hlo_ops`` (no compiler).

Usage:
  python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--out dryrun.json] [--skip-done] [--jobs N]
      (N processes, a cell each at a time)
"""
from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import multiprocessing
import os
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_archs, get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import mesh as M
from repro_torch.utils import PRODUCTION_RULES, tree_distribute

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
    """The tensor leaves of ``tree``, a ``DTensor`` as its local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def rules_for_mesh(mesh) -> dict:
    """:data:`PRODUCTION_RULES` without the axes ``mesh`` lacks (e.g.
    ``pod``); a tuple keeps its kept axes as a tuple."""
    have = set(mesh.mesh_dim_names or ())

    def fix(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in have else None
        kept = tuple(a for a in v if a in have)
        return kept if kept else None

    return {k: fix(v) for k, v in PRODUCTION_RULES.items()}


_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
# the functional collectives' helpers, which move nothing
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def collective_kind(func) -> str | None:
    """The reference's name of the collective ``func`` issues, or None
    for an operation that is no collective; one of the process groups'
    operations that has no such name raises, so that no collective goes
    uncounted."""
    name = func.__name__.split(".")[0]
    if func.namespace == "_dtensor":      # its all-to-all on a card's mesh
        return "all-to-all" if "alltoall" in name else None
    if func.namespace not in ("_c10d_functional", "c10d",
                              "c10d_functional") or name in _NOT_COLLECTIVES:
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    raise ValueError(f"dry run: no collective kind for {func}")


def _no_collectives() -> dict:
    return {**{c: 0 for c in COLLECTIVES},
            **{f"n_{c}": 0 for c in COLLECTIVES}, "total": 0}


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


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames that name no step of a model: this counter and the layout helpers
_NOT_SITES = (os.path.join(_PKG, "launch", "dryrun.py"),
              os.path.join(_PKG, "utils.py"))


def _site() -> str:
    """The innermost line of the port, outside this counter and
    ``utils.py``, on the stack: ``models/layers.py:312``.  Operations the
    autograd engine runs are the ``backward()`` call's."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PKG) and name not in _NOT_SITES:
            return f"{os.path.relpath(name, _PKG)}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _Tally(TorchDispatchMode):
    """Products by dtype, traffic, the bytes read of and written into the
    arguments' storages, and the peak of live storages created during the
    call (the arguments' excluded)."""

    def __init__(self, registry: dict, args, sites: bool = False):
        super().__init__()
        self.registry = registry
        # site -> [products, collective bytes], on a mesh (_site)
        self.sites = defaultdict(lambda: [0, 0]) if sites else None
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
        self.coll = _no_collectives()
        self.in_alltoall = False

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

    def record_collective(self, kind: str, out) -> None:
        n = tree_nbytes(out)
        self.coll[kind] += n
        self.coll[f"n_{kind}"] += 1
        self.coll["total"] += n
        if self.sites is not None:
            self.sites[_site()][1] += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # it dispatches to its local tensors
        if any(t is not torch.Tensor for t in types):
            # DTensor's shape propagation on fake tensors: no work
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = tensors(out)
        if any(type(t) is not torch.Tensor for t in outs):
            return out              # a fake tensor made by that propagation
        packet = func.overloadpacket
        if self.in_alltoall:
            return out        # the gather standing in for an all-to-all
        kind = collective_kind(func)
        if kind is not None:
            self.record_collective(kind, out)
            return out
        if packet in self.registry:
            n = self.registry[packet](*args, **kwargs, out_val=out)
            first = tensors((args, kwargs))[0]
            self.flops[str(first.dtype).removeprefix("torch.")] += n
            if self.sites is not None:
                self.sites[_site()][0] += n
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


class _CountAllToAll:
    """While open, a ``DTensor`` redistribution from one sharded dim to
    another (``shard_dim_alltoall``) is recorded as one all-to-all of its
    result's bytes, and the all-gather the CPU's process group runs in its
    place is not recorded."""

    MODULES = ("torch.distributed.tensor.placement_types",
               "torch.distributed.tensor._collective_utils")

    def __init__(self, tally: _Tally):
        import importlib
        self.tally = tally
        self.mods = [m for m in map(importlib.import_module, self.MODULES)
                     if hasattr(m, "shard_dim_alltoall")]
        if not self.mods:
            raise RuntimeError(f"torch {torch.__version__} has no "
                               "shard_dim_alltoall: an all-to-all would be "
                               "counted as the CPU group's all-gather")
        self.orig = [m.shard_dim_alltoall for m in self.mods]

    def __enter__(self):
        for m, orig in zip(self.mods, self.orig):
            m.shard_dim_alltoall = self._wrap(orig)
        return self

    def _wrap(self, orig):
        def alltoall(*args, **kwargs):
            self.tally.in_alltoall = True
            try:
                out = orig(*args, **kwargs)
            finally:
                self.tally.in_alltoall = False
            self.tally.record_collective("all-to-all", out)
            self.tally.traffic += 2 * nbytes(out)
            self.tally._track(out)
            return out
        return alltoall

    def __exit__(self, *exc):
        for m, orig in zip(self.mods, self.orig):
            m.shard_dim_alltoall = orig


def count_sharded(fn, args) -> dict:
    """Run ``fn(*args)`` once (``DTensor`` arguments on ``meta``) as rank 0
    runs it -> the record's counted keys, rank 0's (module docstring)."""
    gc.collect()
    registry = FlopCounterMode(display=False,
                               custom_mapping=KERNEL_FLOPS).flop_registry
    t0 = time.perf_counter()
    with _Tally(registry, args, sites=True) as tally, \
            _CountAllToAll(tally):
        out = fn(*args)
    seconds = time.perf_counter() - t0
    fresh = {id(t): t for t in tensors(out) if _key(t) not in tally.args}
    return {"lower_s": round(seconds, 2),
            "flops_per_device": float(sum(tally.flops.values())),
            "flops_by_dtype": dict(tally.flops),
            "bytes_per_device": float(tally.traffic),
            "argument_size_in_bytes": tree_nbytes(tensors(args)),
            "output_size_in_bytes": tree_nbytes(tensors(out)),
            "argument_read_bytes": tally.arguments_read(),
            "output_written_bytes": tree_nbytes(list(fresh.values()))
            + tally.arguments_written(),
            "temp_size_in_bytes": tally.peak,
            "collectives": dict(tally.coll),
            "sites": {k: tally.sites[k] for k in sorted(tally.sites)}}


def _fits(rec: dict) -> bool:
    """A rank's arguments plus temporaries within one card's memory."""
    return (rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
            <= CARD_MEMORY_BYTES)


def run_mesh_cell(arch: str, shape: str, multi_pod: bool = False,
                  **variant) -> dict:
    """One cell on the production mesh, as rank 0 of the ``fake`` world
    this process holds (256 ranks, or 512 with ``multi_pod``; see
    :func:`start_world_for`).  A failure is recorded with its error and
    traceback, and the sweep carries on."""
    mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = rules_for_mesh(mesh)
    rec = {"arch": arch, "shape": shape, "mesh": M.mesh_label(mesh),
           "n_devices": mesh.size(), "torch": torch.__version__,
           "ok": False}
    if variant:
        rec["variant"] = dict(variant)
    try:
        bundle = get_arch(arch).make_bundle(shape, rules, mesh, **variant)
        args = tree_distribute(bundle.abstract_args, bundle.arg_logical,
                               rules, mesh)
        rec.update(count_sharded(bundle.fn, args))
        rec["fits_each_card"] = _fits(rec)
        rec["ok"] = True
        print(f"[dryrun] OK  {arch:18s} {shape:14s} mesh={rec['mesh']} "
              f"{rec['lower_s']}s flops/dev={rec['flops_per_device']:.3e} "
              f"args={rec['argument_size_in_bytes'] / 1e9:.2f}GB "
              f"temp={rec['temp_size_in_bytes'] / 1e9:.2f}GB "
              f"coll={rec['collectives']['total']:.3e}B", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] FAIL {arch} {shape} mesh={rec['mesh']}: "
              f"{rec['error']}", flush=True)
    return rec


def start_world_for(multi_pod: bool) -> None:
    """The ``fake`` world of the production mesh, in this process."""
    M.start_fake_world(512 if multi_pod else 256)


def run_cell(arch: str, shape: str, **variant) -> dict:
    """One cell's record (module docstring); a failure is recorded with
    its error and traceback, and the sweep carries on."""
    rec = {"arch": arch, "shape": shape, "mesh": "1", "n_devices": 1,
           "torch": torch.__version__, "ok": False}
    if variant:
        rec["variant"] = dict(variant)
    try:
        bundle = get_arch(arch).make_bundle(shape, **variant)
        rec.update(count(bundle.fn, bundle.abstract_args))
        rec["fits_one_card"] = _fits(rec)
        rec["collectives"] = _no_collectives()
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
    return (r["arch"], r["shape"], r.get("n_devices", 1),
            json.dumps(r.get("variant") or {}, sort_keys=True))


def _records(cells: list, jobs: int):
    """Each cell's record, as it ends, from ``jobs`` processes a world.
    A cell is ``(arch, shape[, multi_pod[, variant]])``, ``multi_pod``
    None (the default) for one card; a mesh's cells run in processes
    holding its ``fake`` world."""
    ctx = multiprocessing.get_context("spawn")
    cells = [(a, s, rest[0] if rest else None,
              rest[1] if len(rest) > 1 else {}) for a, s, *rest in cells]
    card = [c for c in cells if c[2] is None]
    if jobs <= 1:
        yield from (run_cell(a, s, **v) for a, s, _, v in card)
    elif card:
        with concurrent.futures.ProcessPoolExecutor(
                jobs, mp_context=ctx) as pool:
            futures = [pool.submit(run_cell, a, s, **v)
                       for a, s, _, v in card]
            for f in concurrent.futures.as_completed(futures):
                yield f.result()
    for mp in (False, True):
        todo = [c for c in cells if c[2] is mp]
        if not todo:
            continue
        with concurrent.futures.ProcessPoolExecutor(
                max(jobs, 1), mp_context=ctx, initializer=start_world_for,
                initargs=(mp,)) as pool:
            futures = [pool.submit(run_mesh_cell, a, s, mp, **v)
                       for a, s, _, v in todo]
            for f in concurrent.futures.as_completed(futures):
                yield f.result()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="one rank of the 2x16x16 mesh (512 ranks)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="one rank of the 16x16 and of the 2x16x16 mesh")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already OK in --out")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes running cells side by side")
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = [False, True]
    elif args.multi_pod:
        meshes = [True]
    else:
        meshes = [None]
    if args.all:
        pairs = [(arch, shape) for arch in all_archs()
                 for shape in get_arch(arch).shapes]
    else:
        pairs = [(args.arch, args.shape)]
    cells = [(a, s, mp, {}) for mp in meshes for a, s in pairs]

    results, done = [], set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        if args.skip_done:
            done = {cell_key(r) for r in results if r.get("ok")}

    def devices(mp):
        return 1 if mp is None else 512 if mp else 256

    todo = [c for c in cells if (c[0], c[1], devices(c[2]), "{}") not in done]
    for rec in _records(todo, args.jobs):
        results = [r for r in results if cell_key(r) != cell_key(rec)]
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK")


if __name__ == "__main__":
    main()
