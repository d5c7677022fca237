"""The port's dry run (``launch/dryrun.py``) and its cell bundles.

* Every one of the 41 cells' bundle arguments against the reference's
  ``make_bundle(shape, None, mesh=None).abstract_args`` (``jax.eval_shape``:
  nothing allocated on either side): per argument the same leaves' shapes
  and dtypes, sorted (the port keys the reference's lists by position and
  keeps the LM layers as a list of its stacked leaves' slices), and the
  same total bytes.  The decode cells' cache index is a host int in the
  port, the reference's int32 scalar.  The LM prefill and decode cells
  take the port's bf16 serving weights (``final_norm`` f32) where the
  reference takes its f32 masters: their leaves have the reference's
  shapes in those dtypes, and the bytes follow.
* The counted FLOPs of three cheap cells' steps on ``meta`` against
  ``FlopCounterMode`` over the same function on real CPU tensors at a
  smoke size, and those cells through ``run_cell`` at their full size.
* ``temp_size_in_bytes`` against the hand-worked peak of short chains of
  operations, a tensor the autograd graph saves included.
* The bytes the roofline's bound counts: a gather's rows, one slot written
  in place.
* The decode cells count ``decode_attention`` by the kernel's formula, and
  nothing launches.
* ``main`` writing a record, and records from processes (``--jobs``)
  equal to those made in process.
"""
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as ref_get_arch
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.base import META, ShapeSpec
from repro_torch.configs.families import (gnn_bundle, recsys_bundle,
                                          to_device)
from repro_torch.configs.recsys_archs import RECSYS_CONFIGS, smoke_config
from repro_torch.data.graph import make_graph_batch
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.launch import dryrun
from repro_torch.models import dimenet as dn
from repro_torch.models import recsys as rs
from repro_torch.training.optimizer import (OptConfig, _stacked, leaves,
                                            opt_init)

CELLS = [(a, s) for a in all_archs() for s in get_arch(a).shapes]

KEYS = ("arch", "shape", "mesh", "n_devices", "ok", "lower_s",
        "flops_per_device", "flops_by_dtype", "bytes_per_device",
        "argument_size_in_bytes", "output_size_in_bytes",
        "argument_read_bytes", "output_written_bytes",
        "temp_size_in_bytes", "fits_one_card", "collectives")

_ITEMSIZE = {"bfloat16": 2, "bool": 1, "int8": 1, "int32": 4,
             "float32": 4}


def _port_leaves(arg) -> list:
    if isinstance(arg, int):            # the host cache index
        return [((), "int32")]
    if isinstance(arg, torch.Tensor):
        arg = {"": arg}
    out = []
    for path, parts in leaves(arg):
        stack = (len(parts),) if _stacked(arg, path) else ()
        out.append((stack + tuple(parts[0].shape),
                    str(parts[0].dtype).removeprefix("torch.")))
    return sorted(out)


def _serving_dtype(path) -> str:
    """The dtype ``transformer.init_params`` serves a weight in."""
    return "float32" if "final_norm" in jax.tree_util.keystr(path) \
        else "bfloat16"


def _ref_leaves(arg, serving: bool = False) -> list:
    return sorted((tuple(x.shape), _serving_dtype(path) if serving
                   else str(np.dtype(x.dtype)))
                  for path, x in jax.tree_util.tree_leaves_with_path(arg))


def _nbytes(ls) -> int:
    return sum(int(np.prod(s)) * _ITEMSIZE[d] for s, d in ls)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_bundle_arguments_match_the_reference(arch, shape):
    ref = ref_get_arch(arch).make_bundle(shape, None, mesh=None)
    pt = get_arch(arch).make_bundle(shape)
    assert len(pt.abstract_args) == len(ref.abstract_args)
    assert pt.donate_argnums == ref.donate_argnums
    serving = get_arch(arch).family == "lm" and shape != "train_4k"
    for i, (r, p) in enumerate(zip(ref.abstract_args, pt.abstract_args)):
        want, got = _ref_leaves(r, serving and i == 0), _port_leaves(p)
        assert got == want
        assert _nbytes(got) == _nbytes(want) > 0
    for t in dryrun.tensors(pt.abstract_args):
        assert t.device == META


def _counted_on_cpu(fn, args) -> int:
    with FlopCounterMode(display=False,
                         custom_mapping=dryrun.KERNEL_FLOPS) as fc:
        fn(*args)
    return fc.get_total_flops()


def _dlrm_smoke():
    cfg = smoke_config(RECSYS_CONFIGS["dlrm-rm2"])
    bundle = recsys_bundle(cfg, "serve_p99")
    rng = np.random.default_rng(0)
    b = 512
    batch = {"sparse_ids": rng.integers(0, 64, (b, cfg.n_sparse)).astype(
        np.int32), "labels": rng.integers(0, 2, b).astype(np.int32),
        "dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32)}
    real = (rs.init_params(cfg, seed=0, device="cpu"),
            to_device(batch, "cpu"))
    return bundle, real


def _dimenet_smoke():
    cfg = dn.DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4,
                           n_spherical=4, n_radial=4, d_feat=16,
                           task="regression")
    shape = ShapeSpec("molecule", "train",
                      dict(n_nodes=40, n_edges=120, n_triplets=480,
                           d_feat=16, n_graphs=4))
    bundle = gnn_bundle(cfg, shape)
    data = make_graph_batch(n_nodes=40, n_edges=120, d_feat=16, n_classes=5,
                            cap_per_edge=4, seed=0)
    data.pop("labels")
    data["graph_ids"] = (np.arange(40) // 10).astype(np.int32)
    data["targets"] = np.ones(4, np.float32)
    params = dn.init_params(cfg, seed=0, device="cpu")
    real = (params, opt_init(OptConfig(name="adamw"), params),
            to_device(data, "cpu"))
    return bundle, real


def _has_rag_small():
    bundle = get_arch("has-rag").make_bundle("retrieve_batch",
                                             corpus_size=4800)
    g = torch.Generator().manual_seed(0)
    real = tuple(
        torch.randn(t.shape, generator=g) if t.is_floating_point()
        else torch.zeros(t.shape, dtype=t.dtype) if t.dtype == torch.bool
        else torch.randint(-1, 4800, t.shape, generator=g).to(t.dtype)
        for t in bundle.abstract_args)
    return bundle, real


SMOKES = {"dlrm-rm2 serve_p99": _dlrm_smoke,
          "dimenet molecule": _dimenet_smoke,
          "has-rag small": _has_rag_small}


@pytest.mark.parametrize("name", list(SMOKES))
def test_counted_flops_equal_a_real_cpu_run(name):
    bundle, real = SMOKES[name]()
    rec = dryrun.count(bundle.fn, bundle.abstract_args)
    want = _counted_on_cpu(bundle.fn, real)
    assert rec["flops_per_device"] == want > 0
    assert rec["flops_by_dtype"] == {"float32": want}
    assert rec["argument_size_in_bytes"] == dryrun.tree_nbytes(real)


@pytest.mark.parametrize("arch,shape,variant", [
    ("dlrm-rm2", "serve_p99", {}), ("dimenet", "molecule", {}),
    ("has-rag", "retrieve_batch", {"corpus_size": 4800})])
def test_run_cell_records_every_key(arch, shape, variant):
    rec = dryrun.run_cell(arch, shape, **variant)
    assert rec["ok"], rec.get("traceback")
    assert all(k in rec for k in KEYS)
    assert rec["mesh"] == "1" and rec["n_devices"] == 1
    assert rec["collectives"]["total"] == 0
    assert rec.get("variant", {}) == variant
    assert rec["fits_one_card"] and rec["temp_size_in_bytes"] > 0
    assert rec["bytes_per_device"] >= rec["argument_read_bytes"] > 0
    assert rec["argument_read_bytes"] <= rec["argument_size_in_bytes"]


def _chain(x):
    a = x * 2                  # + 4096
    b = a.repeat(2)            # + 8192: the peak, 12288
    del a                      # - 4096
    return b.sum()             # + 4


def _saved(x):
    y = x.exp()                # + 4096, saved by exp's backward
    s = y.sum()                # + 4
    del y                      # the graph keeps it
    z = x * 3                  # + 4096: the peak, 8196
    return s, z


def test_temp_is_the_peak_of_live_storages():
    x = torch.empty(1024, device=META)
    rec = dryrun.count(_chain, (x,))
    assert rec["temp_size_in_bytes"] == 12288
    assert rec["argument_size_in_bytes"] == 4096
    assert rec["output_size_in_bytes"] == 4
    x.requires_grad_(True)
    assert dryrun.count(_saved, (x,))["temp_size_in_bytes"] == 8196


def test_decode_counts_the_kernel_and_launches_nothing():
    spec = get_arch("chatglm3-6b")
    c, d = spec.config, spec.shapes["long_500k"].dims
    bundle = spec.make_bundle("long_500k")
    before = decode_attention.launches
    with FlopCounterMode(display=False,
                         custom_mapping=dryrun.KERNEL_FLOPS) as fc:
        bundle.fn(*bundle.abstract_args)
    counts = fc.get_flop_counts()["Global"]
    b, s = d["global_batch"], d["seq_len"]
    assert counts[torch.ops.repro_torch.decode_attention] == \
        4 * b * c.n_heads * c.d_head * s * c.n_layers
    assert decode_attention.launches == before
    # the K/V rows the kernel reads, once: half of them at half the cache
    q = torch.empty((b, c.n_heads, c.d_head), dtype=torch.bfloat16,
                    device=META)
    kv = torch.empty((b, s, c.n_kv_heads, c.d_head), dtype=torch.bfloat16,
                     device=META)
    reads = dryrun.KERNEL_READS[torch.ops.repro_torch.decode_attention]
    assert reads(q, kv, kv, s) == (q.nbytes, kv.nbytes, kv.nbytes)
    assert reads(q, kv, kv, s // 2) == (q.nbytes, kv.nbytes // 2,
                                        kv.nbytes // 2)


def _lookup(table, ids):
    return torch.nn.functional.embedding(ids, table).sum(dim=1)


def _write_slot(cache, x):
    cache[3] = x               # one row written, the rest not read
    return cache, x * 2


def test_bytes_read_and_written_are_what_the_call_moves():
    table = torch.empty((1000, 8), device=META)          # 32,000 bytes
    ids = torch.empty((4, 5), dtype=torch.int64, device=META)
    rec = dryrun.count(_lookup, (table, ids))
    # the 20 gathered rows (640 bytes) and the ids, not the table
    assert rec["argument_size_in_bytes"] == 32000 + 160
    assert rec["argument_read_bytes"] == 640 + 160
    assert rec["output_written_bytes"] == rec["output_size_in_bytes"] == 128
    cache = torch.empty((10, 8), device=META)
    x = torch.empty(8, device=META)
    rec = dryrun.count(_write_slot, (cache, x))
    assert rec["output_size_in_bytes"] == 320 + 32
    # x read twice, counted once; one row of the cache written, and x * 2
    assert rec["argument_read_bytes"] == 32
    assert rec["output_written_bytes"] == 32 + 32


def test_main_writes_a_record(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "dlrm-rm2", "--shape", "serve_p99", "--out", str(out)]
    dryrun.main(argv)
    dryrun.main(argv + ["--skip-done"])
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["arch"] == "dlrm-rm2" and all(
        k in rec for k in KEYS)
    assert "1/1 cells OK" in capsys.readouterr().out


def test_records_from_processes_equal_in_process():
    """``--jobs`` runs cells in spawned processes: the same records."""
    cells = [("dlrm-rm2", "serve_p99"), ("deepfm", "serve_p99")]
    drop = ("lower_s",)
    want = {r["arch"]: {k: v for k, v in r.items() if k not in drop}
            for r in dryrun._records(cells, 1)}
    got = {r["arch"]: {k: v for k, v in r.items() if k not in drop}
           for r in dryrun._records(cells, 2)}
    assert got == want and len(got) == 2
