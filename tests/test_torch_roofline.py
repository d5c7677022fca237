"""The port's roofline (``launch/roofline.py``) against the reference's
model FLOPs and ``PERF.md``'s hand-worked bounds.

``_model_flops`` must equal the reference's for every one of the 41 cells
(no allocation: both are arithmetic over the configs).  ``bound_s`` is the
least time on one H100: the larger of the products the step must do
(``_bound_flops``: the model FLOPs without the gathers and elementwise
terms) over the peak of the arch's compute dtype and the bytes the call
reads of its arguments and writes over the HBM rate.  The four cells
``PERF.md`` worked by hand are run through the dry run on ``meta`` and
held to its bounds within 3%; every cell's bound is held below the dry
run's own prediction for the port (the LMs at one layer, where the
embedding weighs most).
"""
import math

import pytest

from repro.configs import get_arch as ref_get_arch
from repro.launch.roofline import _model_flops as ref_model_flops
from repro_torch.configs import all_archs, get_arch
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import run_cell

CELLS = [(a, s) for a in all_archs() for s in get_arch(a).shapes]

# PERF.md (H100 80GB HBM3, 700 W): each cell's bound and its measured step
# (chip_smoke.py phase 11); DimeNet's bound is the reference formula's
# (see test_dimenet_bound_counts_the_reference_formula)
PERF_CELLS = {
    ("dlrm-rm2", "train_batch", ()): (15.5e-3, "bytes", 159.4e-3),
    ("has-rag", "retrieve_batch", (("corpus_size", 12_582_912),)):
        (36.9e-3, "operations", 272.6e-3),
    ("dimenet", "minibatch_lg", ()): (55.1e-3, "operations", 219.2e-3),
    ("bert4rec", "train_batch", ()): (2.18, "operations", 15.0),
}


def test_there_are_41_cells():
    assert len(CELLS) == 41


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    want = ref_model_flops(arch, shape, ref_get_arch(arch).config)
    assert rl._model_flops(arch, shape) == want > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_bound_is_below_the_predicted_step(arch, shape):
    """The bound is a least time: at most the larger of the dry run's
    counted products at their dtypes' peaks and its unfused traffic, for
    every cell, and its products at most the reference's model FLOPs,
    which count the LMs' embedding gather (and the recsys lookup) as
    work."""
    lm = get_arch(arch).family == "lm"
    rec = run_cell(arch, shape, **({"n_layers": 1} if lm else {}))
    assert rec["ok"], rec.get("traceback")
    (row,) = rl.analyze([rec])
    assert 0 < row["bound_flops"] <= row["model_flops_total"]
    assert row["bound_s"] <= max(row["t_compute_s"], row["t_memory_s"])


def test_variant_model_flops_use_the_variant():
    full = rl._model_flops("has-rag", "retrieve_batch")
    cut = rl._model_flops("has-rag", "retrieve_batch", *rl.cell_config(
        "has-rag", "retrieve_batch", {"corpus_size": 12_582_912}))
    assert cut == 2 * 12_582_912 * 768 * 2 * 64 and cut < full
    cfg, dims = rl.cell_config("chatglm3-6b", "train_4k",
                               {"n_layers": 15, "global_batch": 8,
                                "n_micro": 4})
    assert cfg.n_layers == 15 and dims["global_batch"] == 8
    n_act = cfg.active_param_count()
    attn = 4 * 8 * 15 * 32 * 128 * 4096 ** 2 / 2
    assert rl._model_flops("chatglm3-6b", "train_4k", cfg, dims) == \
        6 * n_act * 8 * 4096 + 3 * attn


def _record(**kw) -> dict:
    rec = {"arch": "dlrm-rm2", "shape": "serve_p99", "ok": True,
           "flops_per_device": 0.0, "flops_by_dtype": {},
           "bytes_per_device": 0.0, "argument_size_in_bytes": 0,
           "output_size_in_bytes": 0, "argument_read_bytes": 0,
           "output_written_bytes": 0, "temp_size_in_bytes": 0,
           "collectives": {"total": 0}}
    rec.update(kw)
    return rec


def test_analyze_a_hand_made_record():
    mflops = rl._model_flops("dlrm-rm2", "serve_p99")
    rec = _record(flops_per_device=3e9,
                  flops_by_dtype={"bfloat16": 1e9, "float32": 2e9},
                  bytes_per_device=6.7e9,
                  argument_size_in_bytes=int(8.6e9),
                  output_size_in_bytes=int(1.7e9),
                  argument_read_bytes=int(5e9),
                  output_written_bytes=int(1.7e9))
    (row,) = rl.analyze([rec, _record(arch="deepfm", ok=False)])
    assert row["t_compute_s"] == pytest.approx(1e9 / 989e12 + 2e9 / 67e12)
    assert row["t_memory_s"] == pytest.approx(6.7e9 / 3.35e12)
    assert row["t_collective_s"] == 0.0
    assert row["dominant"] == "memory"
    assert row["model_flops_total"] == mflops
    assert row["useful_ratio"] == pytest.approx(mflops / 3e9)
    assert row["roofline_frac"] == pytest.approx(
        mflops / (6.7e9 / 3.35e12) / 67e12)
    # the 6.7e9 bytes read and written (not the 8.6e9 held) against the
    # products, the model FLOPs without the lookup, at the f32 peak
    bflops = mflops - 512 * 26 * 64 * 2
    assert row["bound_flops"] == bflops
    assert row["bound_s"] == pytest.approx(max(6.7e9 / 3.35e12,
                                               bflops / 67e12))
    assert row["bound_by"] == "bytes"
    assert row["useful_ratio"] < 1 and row["note"] == ""
    # a counter that misses work: the ratio reads over 1, with its note
    (low,) = rl.analyze([_record(flops_per_device=1e8,
                                 flops_by_dtype={"float32": 1e8})])
    assert low["useful_ratio"] > 1 and low["note"] == rl.OVER_ONE
    md = rl.to_markdown([row, low])
    assert f"{low['useful_ratio']:.3f}*" in md and rl.OVER_ONE in md
    assert f"{row['useful_ratio']:.3f}*" not in md
    # an LM cell's operations go at the bf16 peak
    lm = _record(arch="chatglm3-6b", shape="decode_32k",
                 flops_per_device=1.0)
    (row,) = rl.analyze([lm])
    assert row["bound_by"] == "operations"
    assert row["bound_s"] == pytest.approx(
        rl._bound_flops("chatglm3-6b", "decode_32k") / 989e12)


@pytest.fixture(scope="module")
def perf_rows():
    recs = [run_cell(a, s, **dict(v)) for a, s, v in PERF_CELLS]
    assert all(r["ok"] for r in recs)
    rows = rl.analyze(recs)
    return {(r["arch"], r["shape"], tuple(sorted(r["variant"].items()))): r
            for r in rows}


@pytest.mark.parametrize("cell", list(PERF_CELLS), ids=lambda c: c[0])
def test_bounds_reproduce_perf_md(perf_rows, cell):
    want, by, step = PERF_CELLS[cell]
    row = perf_rows[cell]
    assert row["bound_s"] == pytest.approx(want, rel=0.03)
    assert row["bound_by"] == by
    # the measured step's share of its bound is a share: at most 1
    assert 0 < row["bound_s"] / step <= 1


def test_dlrm_bound_is_its_arguments_and_outputs(perf_rows):
    row = perf_rows[("dlrm-rm2", "train_batch", ())]
    # the step reads all 25.95 GB of its arguments (table, MLPs, AdamW's
    # two moments, the batch) and rewrites 25.94 GB (the parameters and
    # moments, in place, and the metrics)
    assert row["bound_s"] == pytest.approx((25.95e9 + 25.94e9) / 3.35e12,
                                           rel=1e-3)


@pytest.mark.parametrize("arch,shape", [
    ("chatglm3-6b", "decode_32k"), ("dlrm-rm2", "serve_p99"),
    ("autoint", "retrieval_cand")])
def test_bounds_count_what_the_call_moves(arch, shape):
    """A decode step writes one position of the cache it returns (20.3 MB
    of the 120.3 GB it returns, with the logits) and a lookup reads the
    rows it gathers (retrieval_cand reads no parameter at all): each bound
    is at most the traffic or compute the dry run predicts for the port,
    and below what holding the arguments and outputs would give."""
    rec = run_cell(arch, shape)
    (row,) = rl.analyze([rec])
    held = (rec["argument_size_in_bytes"]
            + rec["output_size_in_bytes"]) / 3.35e12
    assert row["bound_s"] <= max(row["t_memory_s"], row["t_compute_s"])
    assert row["bound_s"] < held
    if shape == "decode_32k":
        assert rec["output_written_bytes"] < rec["output_size_in_bytes"] \
            / 1000
    else:
        assert rec["argument_read_bytes"] < rec["argument_size_in_bytes"] \
            / 30


def test_moe_serving_bound_reads_the_routed_experts_only():
    """The port's MoE decode reads all of a layer's experts; the bound
    counts the top-k any routing must read (arctic-480b: 2 of 128)."""
    variant = {"n_layers": 2}
    rec = run_cell("arctic-480b", "long_500k", **variant)
    cfg, _ = rl.cell_config("arctic-480b", "long_500k", variant)
    expert = 3 * cfg.d_model * cfg.d_ff * 2          # bf16 serving weights
    unrouted = 2 * (128 - 2) * expert
    assert rl._unrouted_bytes("arctic-480b", "long_500k", cfg) == unrouted
    moved = rec["argument_read_bytes"] + rec["output_written_bytes"]
    assert moved - unrouted > 2 * 2 * expert
    (row,) = rl.analyze([rec])
    assert row["bound_by"] == "bytes"
    assert row["bound_s"] == pytest.approx((moved - unrouted) / 3.35e12)
    # a train step reads and updates every expert
    assert rl._unrouted_bytes("arctic-480b", "train_4k") == 0
    assert rl._unrouted_bytes("chatglm3-6b", "decode_32k") == 0


def test_dimenet_bound_counts_the_reference_formula(perf_rows):
    """PERF.md's PR 24 figure, 60.7 ms, counted the port's forward products
    (4.07 TFLOP a step); the reference's formula leaves out the triplet
    message product ``m_kj @ w_msg`` (2 T d^2 a block) and prices the edge
    MLPs at 8 E d^2.  With that product added back it is within 1% of
    4.07 TFLOP, so the two differ by the formula, and both are bounds."""
    cfg = get_arch("dimenet").config
    dims = get_arch("dimenet").shapes["minibatch_lg"].dims
    row = perf_rows[("dimenet", "minibatch_lg", ())]
    mflops = row["model_flops_total"]
    m_kj = 3 * cfg.n_blocks * 2 * dims["n_triplets"] * cfg.d_hidden ** 2
    assert mflops + m_kj == pytest.approx(4.07e12, rel=0.01)
    assert row["bound_s"] == pytest.approx(mflops / 67e12)
    assert 60.7e-3 == pytest.approx(4.07e12 / 67e12, rel=1e-3)


def test_markdown_prints_the_bound_and_no_share(perf_rows):
    md = rl.to_markdown(list(perf_rows.values()))
    head = md.splitlines()[0]
    assert "bound (s)" in head and "bound by" in head
    assert "share" not in md
    for line in md.splitlines()[2:len(perf_rows) + 2]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert math.isfinite(float(cells[8])) and cells[9] in (
            "bytes", "operations")
