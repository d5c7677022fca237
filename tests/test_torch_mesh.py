"""The logical-axis sharding layer against the reference's, and the
multi-rank dry run.

* (a) ``logical_to_placements`` against the reference's
  ``logical_to_spec`` for every rule on the 16x16 and 2x16x16 production
  meshes and the local 1x1 one (mesh stand-ins: the function reads only
  the axis names and sizes): each tensor dim is split over the same mesh
  axes, in the same major-to-minor order, a size-1 axis splitting
  nothing.  ``rules_for_mesh`` against the reference's, as
  ``tests/test_perf_paths.py:50`` builds it.
* (b) Every cell's bundle ``arg_logical`` (so the parameters', the
  optimizer state's, MoE's and the batches' logical trees) against the
  reference's, leaf by leaf, in all 41 cells: without a mesh here, and on
  both production meshes in subprocesses holding the reference's 512
  host devices and the port's ``fake`` world of 256 or 512 ranks.
* (e) ``reshard_tree`` onto a 2x2 mesh in four gloo ranks: each rank's
  local shard equals the reference's addressable shard at the same mesh
  coordinate, exactly.
* (f) The fake-world dry run, in subprocesses: dlrm-rm2 serve_p99
  ``--multi-pod`` (the reference's own cell) is OK; rank 0's argument
  bytes equal the local shard bytes the reference's specs imply; its
  FLOPs lie between the one-card count over the ranks and the one-card
  count; a train_4k cell (chatglm3-6b, one layer) all-gathers at least
  its ``fsdp``-sharded parameters' bytes times (n-1)/n, and an MoE one
  (arctic-480b, one layer) its expert weights at the line that gathers
  them, the record's ``sites`` adding up to its counts; on a 1x1 mesh
  every numeric field equals the one-card record's; each record names
  its torch release; and ``make_production_mesh``'s shapes and names at
  worlds 256 and 512.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro.configs import get_arch as ref_get_arch
from repro.utils import PRODUCTION_RULES as REF_RULES
from repro.utils import logical_to_spec
from repro_torch.configs import all_archs, get_arch
from repro_torch.launch.dryrun import rules_for_mesh, run_cell
from repro_torch.training.optimizer import _stacked_logical
from repro_torch.utils import (LOCAL_RULES, PRODUCTION_RULES, Replicate,
                               Shard, logical_to_placements, tree_placements)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TESTS = os.path.dirname(__file__)


class FakeMesh:
    """The axis names and sizes of a mesh, for both packages' rule code."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)
        self.ndim = len(shape)

    def size(self, i: int) -> int:
        return list(self.shape.values())[i]


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1}}


def ref_rules_for_mesh(mesh) -> dict:
    """The reference's ``rules_for_mesh``.  Its module adds 512 host
    devices to ``XLA_FLAGS`` when imported; the flags are put back at
    once, so that the JAX tests this worker runs next see one device."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import rules_for_mesh as ref
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return ref(mesh)


def _split_by_spec(spec, ndim: int, mesh: FakeMesh) -> list[tuple]:
    """Per tensor dim, the mesh axes (of size > 1) that split it."""
    out = []
    for d in range(ndim):
        v = spec[d] if d < len(spec) else None
        axes = () if v is None else (v,) if isinstance(v, str) else tuple(v)
        out.append(tuple(a for a in axes if mesh.shape[a] > 1))
    return out


def _split_by_placements(pl, ndim: int, mesh: FakeMesh) -> list[tuple]:
    out = [[] for _ in range(ndim)]
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            out[p.dim].append(mesh.mesh_dim_names[i])
        else:
            assert p == Replicate()
    return [tuple(a) for a in out]


def _logicals():
    names = sorted(PRODUCTION_RULES)
    out = [(n,) for n in names]
    out += [(None, n) for n in names]
    out += [(a, b) for a in names for b in names
            if not set(_axes(a)) & set(_axes(b))]
    return out


def _axes(name):
    v = PRODUCTION_RULES[name]
    return () if v is None else (v,) if isinstance(v, str) else v


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_rules_for_mesh_equal_reference(mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    assert rules_for_mesh(mesh) == ref_rules_for_mesh(mesh)
    assert PRODUCTION_RULES == REF_RULES
    assert LOCAL_RULES == {k: None for k in REF_RULES}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_equal_reference_specs(mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    rules = rules_for_mesh(mesh)
    ref_rules = ref_rules_for_mesh(mesh)
    checked = 0
    for lg in _logicals():
        want = _split_by_spec(logical_to_spec(lg, ref_rules), len(lg), mesh)
        got = _split_by_placements(logical_to_placements(lg, rules, mesh),
                                   len(lg), mesh)
        assert got == want, lg
        checked += 1
    assert checked > 100


def test_tree_placements_map_every_leaf():
    mesh = FakeMesh(MESHES["2x16x16"])
    rules = rules_for_mesh(mesh)
    tree = {"w": ("fsdp", "d_ff"), "layers": [{"b": ("batch",)}] * 2,
            "step": ()}
    got = tree_placements(tree, rules, mesh)
    assert got["w"] == (Replicate(), Shard(0), Shard(1))
    assert got["layers"] == [{"b": (Shard(0), Shard(0), Replicate())}] * 2
    assert got["step"] == (Replicate(),) * 3


def test_placements_refuse_a_double_map():
    mesh = FakeMesh(MESHES["16x16"])
    rules = rules_for_mesh(mesh)
    with pytest.raises(ValueError, match="maps two dims"):
        logical_to_placements(("fsdp", "batch"), rules, mesh)
    with pytest.raises(ValueError, match="order"):
        logical_to_placements(("x",), {"x": ("model", "data")}, mesh)


# ---------------------------------------------------------------------------
# (b) the logical trees of every cell
# ---------------------------------------------------------------------------

def _norm(tree):
    """Lists as dicts keyed by position; logical leaves as lists."""
    if isinstance(tree, dict):
        return {str(k): _norm(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and all(isinstance(e, str) or e is None
                                       for e in tree):
        return list(tree)
    return {str(i): _norm(v) for i, v in enumerate(tree)}


def port_logical(arch, shape, rules=None, mesh=None):
    """The port's ``arg_logical`` in the reference's layout: the LM
    parameters' per-layer list stacked (``opt_state_logical``'s form)."""
    lg = list(get_arch(arch).make_bundle(shape, rules, mesh).arg_logical)
    if get_arch(arch).family == "lm":
        lg[0] = {**lg[0], "layers": _stacked_logical(lg[0]["layers"])}
    return _norm(tuple(lg))


CELLS = [(a, s) for a in all_archs() for s in get_arch(a).shapes]


def test_cell_count():
    assert len(CELLS) == 41


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arg_logical_equals_reference_without_mesh(arch, shape):
    ref = ref_get_arch(arch).make_bundle(shape, None, mesh=None).arg_logical
    assert port_logical(arch, shape) == _norm(tuple(ref))


MESH_TREES = r"""
import json, sys
sys.path.insert(0, sys.argv[3])
import jax
from repro.configs import all_archs as ref_all, get_arch as ref_get_arch
from repro.launch.dryrun import rules_for_mesh as ref_rules_for_mesh
from repro.launch.mesh import make_production_mesh as ref_mesh
from repro_torch.configs import all_archs, get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import rules_for_mesh
from test_torch_mesh import _norm, port_logical
mp = sys.argv[1] == "1"
M.start_fake_world(512 if mp else 256)
mesh = M.make_production_mesh(multi_pod=mp, device_type="cpu")
rmesh = ref_mesh(multi_pod=mp)
out = {"mesh": [mesh.size(i) for i in range(mesh.ndim)],
       "names": list(mesh.mesh_dim_names), "ref_mesh": dict(rmesh.shape),
       "cells": {}}
assert all_archs() == ref_all()
for a in all_archs():
    for s in get_arch(a).shapes:
        ref = ref_get_arch(a).make_bundle(s, ref_rules_for_mesh(rmesh), rmesh)
        out["cells"][f"{a}/{s}"] = [
            port_logical(a, s, rules_for_mesh(mesh), mesh),
            _norm(tuple(ref.arg_logical))]
json.dump(out, open(sys.argv[2], "w"))
"""


def _subprocess(code, *args, xla=512, timeout=400):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={xla}")
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_arg_logical_and_mesh_equal_reference_on_production_mesh(
        multi_pod, tmp_path):
    _subprocess(MESH_TREES, int(multi_pod), tmp_path / "trees.json", TESTS)
    got = json.loads((tmp_path / "trees.json").read_text())
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ["pod", "data", "model"] if multi_pod else ["data", "model"]
    assert got["mesh"] == list(shape) and got["names"] == names
    assert got["ref_mesh"] == dict(zip(names, shape))
    assert len(got["cells"]) == 41
    for cell, (port, ref) in got["cells"].items():
        assert port == ref, cell


# ---------------------------------------------------------------------------
# (e) reshard_tree
# ---------------------------------------------------------------------------

RESHARD_REF = r"""
import sys, numpy as np, jax
from jax.sharding import Mesh
from repro.checkpoint.manager import reshard_tree
from repro.launch.dryrun import rules_for_mesh
d = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
logical = {"w": ("fsdp", "d_ff"), "e": ("emb_vocab", None),
           "c": ("corpus", None), "v": ("batch",)}
placed = reshard_tree({k: d[k] for k in d.files}, logical,
                      rules_for_mesh(mesh), mesh)
out = {}
for k, arr in placed.items():
    for sh in arr.addressable_shards:
        i, j = map(int, np.argwhere(mesh.devices == sh.device)[0])
        out[f"{k}/{i * 2 + j}"] = np.asarray(sh.data)
np.savez(sys.argv[2], **out)
"""


def test_reshard_tree_equals_reference_shards(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "e": rng.normal(size=(12, 3)).astype(np.float32),
            "c": rng.normal(size=(16, 2)).astype(np.float32),
            "v": rng.integers(0, 9, 10).astype(np.int32)}
    np.savez(tmp_path / "tree.npz", **tree)
    ranks = W.run(str(tmp_path), "reshard")
    _subprocess(RESHARD_REF, tmp_path / "tree.npz", tmp_path / "ref.npz",
                xla=4)
    ref = dict(np.load(tmp_path / "ref.npz"))
    for r, got in enumerate(ranks):
        for k in tree:
            np.testing.assert_array_equal(got[k], ref[f"{k}/{r}"],
                                          err_msg=f"{k} rank {r}")


# ---------------------------------------------------------------------------
# (f) the fake-world dry run
# ---------------------------------------------------------------------------

def test_multi_pod_cell_cli(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dlrm-rm2", "--shape", "serve_p99", "--multi-pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert "1/1 cells OK" in run.stdout, run.stdout + run.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["mesh"] == "2x16x16"
    assert rec["n_devices"] == 512 and rec["fits_each_card"]
    assert rec["torch"] == torch.__version__


SHARD_BYTES = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.dryrun import rules_for_mesh
from repro.launch.mesh import make_production_mesh
from repro.utils import tree_specs
mesh = make_production_mesh(multi_pod=True)
rules = rules_for_mesh(mesh)
b = get_arch("dlrm-rm2").make_bundle("serve_p99", rules, mesh)
total = 0
for args, lg in zip(b.abstract_args, b.arg_logical):
    specs = jax.tree.leaves(tree_specs(lg, rules),
                            is_leaf=lambda x: isinstance(x, P))
    for a, s in zip(jax.tree.leaves(args), specs):
        shape = NamedSharding(mesh, s).shard_shape(a.shape)
        total += int(np.prod(shape)) * a.dtype.itemsize
print("BYTES", total)
"""

PORT_CELLS = r"""
import json, sys
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.utils import _map_logical, tree_distribute
M.start_fake_world(256)
mesh = M.make_production_mesh(device_type="cpu")
rules = D.rules_for_mesh(mesh)
b = get_arch("chatglm3-6b").make_bundle("train_4k", rules, mesh, n_layers=1)
args = tree_distribute(b.abstract_args, b.arg_logical, rules, mesh)
fsdp = []
_map_logical(lambda t, lg: fsdp.append(D.nbytes(t.to_local()) * mesh.size(0))
             if "fsdp" in lg else None, args[0], b.arg_logical[0])
rec = D.count_sharded(b.fn, args)
json.dump({"all_gather": rec["collectives"]["all-gather"],
           "fsdp_bytes": sum(fsdp), "n": mesh.size(0),
           "flops": rec["flops_per_device"]}, open(sys.argv[1], "w"))
"""

LOCAL_CELL = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.utils import tree_distribute
M.start_fake_world(1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
rules = D.rules_for_mesh(mesh)
b = get_arch("dlrm-rm2").make_bundle("serve_p99", rules, mesh)
args = tree_distribute(b.abstract_args, b.arg_logical, rules, mesh)
one = get_arch("dlrm-rm2").make_bundle("serve_p99")
json.dump({"mesh": D.count_sharded(b.fn, args),
           "card": D.count(one.fn, one.abstract_args)}, open(sys.argv[1], "w"))
"""


def test_multi_pod_record_against_reference_and_one_card(tmp_path):
    """dlrm-rm2 serve_p99 on 512 ranks: argument bytes as the reference's
    specs shard them (rank 0, the largest shard), FLOPs between the
    one-card count over the ranks and the one-card count."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "dlrm-rm2", "--shape", "serve_p99",
                    "--multi-pod", "--out", str(out)], capture_output=True,
                   text=True, env=env, timeout=300, check=True)
    (rec,) = json.loads(out.read_text())
    ref = _subprocess(SHARD_BYTES).stdout
    ref_bytes = int([ln for ln in ref.splitlines()
                     if ln.startswith("BYTES")][0].split()[1])
    assert rec["argument_size_in_bytes"] == ref_bytes
    card = run_cell("dlrm-rm2", "serve_p99")
    assert card["flops_per_device"] / 512 <= rec["flops_per_device"] \
        <= card["flops_per_device"]


def test_train_cell_gathers_its_fsdp_parameters(tmp_path):
    _subprocess(PORT_CELLS, tmp_path / "cells.json", timeout=600)
    got = json.loads((tmp_path / "cells.json").read_text())
    n = got["n"]
    assert got["fsdp_bytes"] > 0
    assert got["all_gather"] >= got["fsdp_bytes"] * (n - 1) / n
    card = run_cell("chatglm3-6b", "train_4k", n_layers=1)
    assert card["flops_per_device"] / 256 <= got["flops"] \
        <= card["flops_per_device"]


MOE_CELL = r"""
import inspect, json, sys
import torch
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.models import layers as L
from repro_torch.utils import tree_distribute
M.start_fake_world(256)
mesh = M.make_production_mesh(device_type="cpu")
rules = D.rules_for_mesh(mesh)
b = get_arch("arctic-480b").make_bundle("train_4k", rules, mesh, n_layers=1)
args = tree_distribute(b.abstract_args, b.arg_logical, rules, mesh)
rec = D.count_sharded(b.fn, args)
moe = args[0]["layers"][0]["moe"]
experts = sum(D.nbytes(moe[k].to_local()) * mesh.size(0)
              for k in ("w_in", "w_gate", "w_out"))
lines, first = inspect.getsourcelines(L._moe_experts)
line = first + next(i for i, ln in enumerate(lines)
                    if "constrain(params[k]" in ln)
site = f"models/layers.py:{line}"
json.dump({"rec": rec, "experts_bytes": experts, "n": mesh.size(0),
           "site": rec["sites"].get(site), "torch": torch.__version__},
          open(sys.argv[1], "w"))
"""


def test_moe_gathers_its_experts_and_sites_sum_to_the_counts(tmp_path):
    """arctic-480b train_4k at one layer on 256 ranks: each expert weight
    is all-gathered over ``fsdp`` before its products (at least its
    sharded bytes times (n-1)/n at that line), whatever ``DTensor``'s
    release would pick; the record's ``sites`` add up to its products and
    collective bytes."""
    _subprocess(MOE_CELL, tmp_path / "moe.json", timeout=600)
    got = json.loads((tmp_path / "moe.json").read_text())
    rec, n = got["rec"], got["n"]
    assert got["site"] is not None
    assert got["site"][1] >= got["experts_bytes"] * (n - 1) / n > 0
    assert sum(f for f, _ in rec["sites"].values()) \
        == rec["flops_per_device"]
    assert sum(c for _, c in rec["sites"].values()) \
        == rec["collectives"]["total"]


def test_local_mesh_record_equals_one_card(tmp_path):
    _subprocess(LOCAL_CELL, tmp_path / "local.json")
    got = json.loads((tmp_path / "local.json").read_text())
    mesh, card = got["mesh"], got["card"]
    assert mesh["collectives"]["total"] == 0
    for key, v in card.items():
        if key == "lower_s":
            continue
        assert mesh[key] == v, key
