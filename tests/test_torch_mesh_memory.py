"""A rank's memory on the production meshes against the reference's
compiled per-device memory, and the shard-local steps' collectives.

* The reference's cells are compiled (``repro.launch.dryrun.run_cell``'s
  own lower, compile and ``memory_analysis()``) in a subprocess holding
  512 JAX host devices.  On jax 0.9 ``jax.make_mesh`` makes ``Explicit``
  axes, on which the reference's ``with_sharding_constraint`` calls fail;
  the subprocess puts a mesh builder with ``AxisType.Auto`` axes in place
  of the name ``make_production_mesh`` in that module's namespace (no file
  of the reference changes).  Its one-device memory comes from the same
  step jitted without shardings.
* The port's records are rank 0's in a ``fake`` world of 256 or 512 ranks
  (``launch/dryrun.py::run_mesh_cell``), and its one-card records
  ``run_cell``'s, all on ``meta``.
* Each cell's rank-0 arguments + temporaries must be at most 1.5 times the
  reference's per-device arguments + temporaries times max(1, r1), r1 the
  port's one-device temporaries over the reference's (the two counters
  calibrated on one device): the ten cells on 16x16, and dlrm-rm2
  train_batch and DimeNet minibatch_lg on 2x16x16, where a rank holds no
  more than on 16x16.
* dlrm-rm2 train_batch's and DimeNet minibatch_lg's collective bytes on
  16x16 within 10% of counts worked by hand from the layouts (below).
* In a fake world of 256 ranks: ``gather_rows``, ``segment_sum`` and
  ``vocab_lookup`` issue the collectives worked by hand and the dry run
  counts them; the row-sharded tables' gradients reach ``like_param`` with
  their tables' placements and shard shapes; ``like_param`` raises on a
  gradient partial where its parameter is sharded.

The subprocesses run side by side (about 30 s on an 8-core box).
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

CELLS = [("dlrm-rm2", "train_batch"), ("deepfm", "train_batch"),
         ("autoint", "train_batch"), ("autoint", "serve_bulk"),
         ("bert4rec", "train_batch"), ("bert4rec", "serve_bulk"),
         ("dimenet", "full_graph_sm"), ("dimenet", "minibatch_lg"),
         ("dimenet", "ogb_products"), ("has-rag", "retrieve_batch")]
MULTI_POD = [("dlrm-rm2", "train_batch"), ("dimenet", "minibatch_lg")]
BOUND = 1.5
HAND_TOL = 0.10

REF = r"""
import json, sys
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as D
from repro.configs import get_arch


def make_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


D.make_production_mesh = make_production_mesh
out = {}
for cell in json.loads(sys.argv[2]):
    arch, shape, n = cell
    if n == 1:
        b = get_arch(arch).make_bundle(shape, None, None)
        mem = jax.jit(b.fn, donate_argnums=b.donate_argnums).lower(
            *b.abstract_args).compile().memory_analysis()
        rec = {"ok": True, "argument_size_in_bytes": mem.argument_size_in_bytes,
               "temp_size_in_bytes": mem.temp_size_in_bytes}
    else:
        rec = D.run_cell(arch, shape, multi_pod=n == 512)
        rec.pop("traceback", None)
    out[f"{arch}/{shape}/{n}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""

PORT = r"""
import json, sys
from repro_torch.launch import dryrun as D
n = int(sys.argv[3])
if n > 1:
    D.start_world_for(n == 512)
out = {}
for arch, shape in json.loads(sys.argv[2]):
    rec = (D.run_cell(arch, shape) if n == 1
           else D.run_mesh_cell(arch, shape, n == 512))
    out[f"{arch}/{shape}/{n}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


def _start(code, out, *args, xla=False):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    if xla:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    return subprocess.Popen([sys.executable, "-c", code, str(out),
                             *map(str, args)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _join(procs, timeout=240) -> dict:
    recs = {}
    for proc, out in procs:
        log, _ = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, log[-4000:]
        recs.update(json.loads(out.read_text()))
    return recs


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every record: ``{arch}/{shape}/{1|256|512}``, the reference's under
    ``ref`` and the port's under ``port``."""
    root = tmp_path_factory.mktemp("mesh_memory")
    mesh = [[a, s, 256] for a, s in CELLS] + [[a, s, 512]
                                              for a, s in MULTI_POD]
    one = [[a, s, 1] for a, s in CELLS]
    ref = [(_start(REF, root / f"ref{i}.json", json.dumps(c), xla=True),
            root / f"ref{i}.json") for i, c in enumerate((mesh, one))]
    port = [(_start(PORT, root / f"port{n}.json", json.dumps(cells), n),
             root / f"port{n}.json")
            for n, cells in ((256, CELLS), (512, MULTI_POD), (1, CELLS))]
    return {"port": _join(port), "ref": _join(ref)}


def _gb(rec) -> float:
    return (rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]) / 1e9


def _bound(records, arch, shape, n) -> tuple[float, float]:
    """(the port's rank-0 arguments + temp, its bound), in GB."""
    port = records["port"][f"{arch}/{shape}/{n}"]
    ref = records["ref"][f"{arch}/{shape}/{n}"]
    assert port["ok"], port.get("error")
    assert ref["ok"], ref.get("error")
    r1 = records["port"][f"{arch}/{shape}/1"]["temp_size_in_bytes"] \
        / records["ref"][f"{arch}/{shape}/1"]["temp_size_in_bytes"]
    return _gb(port), BOUND * _gb(ref) * max(1.0, r1)


@pytest.mark.parametrize("arch,shape,n", [(a, s, 256) for a, s in CELLS]
                         + [(a, s, 512) for a, s in MULTI_POD])
def test_rank_memory_within_reference_bound(records, arch, shape, n):
    got, bound = _bound(records, arch, shape, n)
    assert got <= bound, f"{arch} {shape} on {n} ranks: {got:.3f} GB a " \
        f"rank, bound {bound:.3f} GB"


@pytest.mark.parametrize("arch,shape", MULTI_POD)
def test_rank_memory_does_not_grow_with_ranks(records, arch, shape):
    p = records["port"]
    assert _gb(p[f"{arch}/{shape}/512"]) <= _gb(p[f"{arch}/{shape}/256"])


def _gather(n: int, row: int) -> int:
    """An all-gather over (data, model) of ``n`` rows of ``row`` bytes,
    one step an axis (model, then data): results of n/16 and n rows."""
    return (n // 16 + n) * row


def _scatter(n: int, row: int) -> int:
    """A reduce-scatter of ``n`` rows over (data, model), one step an
    axis: results of n/16 and n/256 rows."""
    return (n // 16 + n // 256) * row


def hand_count(arch: str) -> int:
    """Rank 0's collective bytes on 16x16, from the layouts.

    dlrm-rm2 train_batch: the lookup's all-reduce over ``model`` of the
    rank's rows ([65536/16, 26, 64] f32), the table shard's gradient
    all-reduced over ``data`` (33,762,816/16 x 64 x 4 B) and the dense
    layers' gradients all-reduced over ``data`` (762,177 f32).

    DimeNet minibatch_lg (N 169,984 nodes, E 168,960 edges, d 128, 6
    blocks): forward, the positions [N, 3] and the edge vectors and
    lengths [E, 4] gathered once each, h [N, d] gathered once, and in each
    block m [E, d] gathered, the triplet sum reduce-scattered to [E, d]
    and the node sum to [N, d]; backward, h's and each m's gradient
    reduce-scattered, each block's two sums' gradients gathered.  The
    weights' gathers and gradients (KBs) are left out."""
    if arch == "dlrm-rm2":
        return 4096 * 26 * 64 * 4 + 33_762_816 // 16 * 64 * 4 + 762_177 * 4
    n, e, row = 169_984, 168_960, 128 * 4
    block = _gather(e, row) + _scatter(e, row) + _scatter(n, row)
    forward = _gather(n, 12) + _gather(e, 16) + _gather(n, row) + 6 * block
    backward = _scatter(n, row) + 6 * (_scatter(e, row) + _gather(e, row)
                                       + _gather(n, row))
    return forward + backward


@pytest.mark.parametrize("arch,shape", MULTI_POD)
def test_collectives_match_the_hand_count(records, arch, shape):
    got = records["port"][f"{arch}/{shape}/256"]["collectives"]["total"]
    want = hand_count(arch)
    assert abs(got - want) <= HAND_TOL * want, (got, want)


HELPERS = r"""
import json, sys
import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.training import train as T
from repro_torch.training.optimizer import like_param
from repro_torch.utils import (gather_rows, segment_sum, tree_distribute,
                               vocab_lookup)
from repro_torch.configs import get_arch
M.start_fake_world(256)
mesh = M.make_production_mesh(device_type="cpu")
rules = D.rules_for_mesh(mesh)
meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                    device="meta")
out = {}

# gather_rows then segment_sum over 4096 edge rows of 8 f32
x, idx = tree_distribute((meta(4096, 8), meta(4096, dtype=torch.int64)),
                         (("edges", None), ("edges",)), rules, mesh)
x.requires_grad_(True)


def edges(x, idx):
    z = segment_sum(gather_rows(x, idx), idx, 4096, ("edges", None), rules)
    (z * z).sum().full_tensor().backward()


out["edges"] = D.count_sharded(edges, (x, idx))["collectives"]

# vocab_lookup of a [1024, 8] table row-sharded over model, ids [64, 4]
# over data
table, ids = tree_distribute((meta(1024, 8), meta(64, 4, dtype=torch.int64)),
                             (("emb_vocab", None), ("batch", None)), rules,
                             mesh)
table.requires_grad_(True)


def lookup(table, ids):
    vocab_lookup(table, ids).sum().full_tensor().backward()
    out["table_grad"] = [str(table.grad.placements),
                         list(table.grad.to_local().shape)]


out["lookup"] = D.count_sharded(lookup, (table, ids))["collectives"]

# the tables' gradients at like_param in the cells' train steps
seen = []


def record(g, p):
    seen.append([list(p.shape), str(g.placements), str(p.placements),
                 list(g.to_local().shape), list(p.to_local().shape)])
    return like_param(g, p)


T.like_param = record
for arch in ("dlrm-rm2", "deepfm"):
    b = get_arch(arch).make_bundle("train_batch", rules, mesh)
    args = tree_distribute(b.abstract_args, b.arg_logical, rules, mesh)
    b.fn(*args)
out["grads"] = seen

# a gradient partial over the axis its parameter is sharded on
p, g = (torch.distributed.tensor.DTensor.from_local(
    meta(16, 8), mesh, pl, run_check=False) for pl in
    ([Replicate(), Shard(0)], [Partial(), Partial()]))
try:
    like_param(g, p)
    out["raised"] = None
except ValueError as e:
    out["raised"] = str(e)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    out = tmp_path_factory.mktemp("helpers") / "helpers.json"
    return _join([(_start(HELPERS, out), out)])


def test_shard_local_collectives_are_counted(helpers):
    """x [4096, 8] f32 over (data, model): forward, x gathered (4096/16 +
    4096 rows of 32 B) and the segment sum reduce-scattered (4096/16 +
    4096/256 rows); backward (of the sum of squares, whose gradient is
    laid out as the sum), the same two the other way round.  The
    lookup: its [64/16, 4, 8] f32 rows all-reduced over ``model``, then
    its gradient's [1024/16, 8] f32 shard over ``data``."""
    c = helpers["edges"]
    assert c["all-gather"] == 2 * (256 + 4096) * 32
    assert c["reduce-scatter"] == 2 * (256 + 16) * 32
    assert c["all-reduce"] <= 16                  # the loss's scalar
    c = helpers["lookup"]
    assert c["all-gather"] == c["reduce-scatter"] == 0
    assert c["all-reduce"] - 16 <= 4 * 4 * 8 * 4 + 64 * 8 * 4 \
        <= c["all-reduce"]


def test_table_gradients_have_their_tables_placements(helpers):
    """The row-sharded tables (dlrm-rm2's [33,762,816, 64], deepfm's table
    and first-order weights) reach ``like_param`` laid out as their
    parameters, a shard each; no rank holds a whole-table gradient."""
    placements, shape = helpers["table_grad"]
    assert placements == "(Replicate(), Shard(dim=0))" and shape == [64, 8]
    tables = [s for s in helpers["grads"] if s[0][0] >= 1 << 20]
    assert len(tables) == 3
    for shape, g_pl, p_pl, g_local, p_local in tables:
        assert g_pl == p_pl and g_local == p_local, shape
        assert g_local[0] * 16 == shape[0]


def test_like_param_raises_on_a_whole_shape_partial(helpers):
    assert helpers["raised"] and "partial over mesh dims" in \
        helpers["raised"]
