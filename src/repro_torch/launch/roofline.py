"""Roofline of the dry run's records on H100s.

Twin of ``src/repro/launch/roofline.py``.  The constants are one NVIDIA
H100 SXM at 700 W (data sheet): 989e12 FLOP/s for dense bf16 products on
the tensor cores, 67e12 for f32 (the port keeps TF32 off), 3.35e12 B/s of
HBM3.  ``CHIPS`` is the record's ``n_devices``: 1 for the one-card
records, 256 or 512 for one rank of a production mesh, whose counts are
that rank's.  Per cell (``launch/dryrun.py``'s record):

  t_compute_s    = bf16 FLOPs / 989e12 + f32 FLOPs / 67e12     [s]
                   (the counted products, ``flops_by_dtype``)
  t_memory_s     = bytes_per_device / 3.35e12                   [s]
                   (the unfused traffic: each operation's inputs and
                   outputs; a prediction of the eager port, not a bound)
  t_collective_s = the rank's collective bytes (``collectives.total``,
                   each collective's result) / LINK_BW, 50e9 B/s: one
                   400 Gb/s NDR InfiniBand link a GPU (an HGX / DGX H100
                   node has eight ConnectX-7 400 Gb/s ports, one a GPU:
                   NVIDIA DGX H100 user guide).  Every axis of both
                   production meshes spans more than one 8-GPU node (16
                   ranks a ``data`` or ``model`` row, 2 pods), so each
                   collective's slowest hop is that link, not NVLink.
                   0 on one card
  dominant       = the largest of the three
  model_flops_total = :func:`_model_flops`, the reference's analytic
                   useful FLOPs (6 N_active tokens for training, the
                   forward for serving, the attention S^2 term)
  useful_ratio   = model_flops_total / counted FLOPs: over 1 where the
                   formula counts work the counter does not (the
                   embedding's gather in N_active, the lookup term, work
                   outside products); such a row carries ``note``
  roofline_frac  = model_flops_total / max(terms) / the peak of the arch's
                   compute dtype: the reference's column, a ratio of two
                   predictions, never a share of a measured time
  bound_flops    = :func:`_bound_flops`: the products the step cannot do
                   without, for the bound.  The reference's formula less
                   what is no product: the LMs' embedding table (gathered;
                   N_active counts it) and norm scales, the recsys lookup
                   (a gather) and deepfm's elementwise FM term; an LM
                   prefill unembeds its last position only.  Dropping work
                   only lowers a bound, so it is at most the counted
                   products (the counter sees the backward's and the
                   recompute's products too)
  bound_s, bound_by = the least time the card could take: the larger of
                   bound_flops over the peak of the arch's compute dtype
                   (bf16 for the LMs, f32 for the rest) and the bytes
                   that must move, each argument byte the call reads
                   read once and each output byte written once,
                   (argument_read_bytes + output_written_bytes) / 3.35e12
                   (``launch/dryrun.py``: a training step reads and
                   rewrites all its arguments, so these are its argument
                   and output sizes; a decode step writes one position of
                   the cache it returns, and a lookup reads the rows it
                   gathers, not the whole table), less, in the MoE serving
                   cells, the experts no routing has to read
                   (:func:`_unrouted_bytes`).  The LM prefill and decode
                   cells are bounds of the port's bf16 serving weights
                   (``configs/families.py::lm_bundle``), not of the
                   reference's f32 masters.  On a mesh the bound stays a
                   least time a rank: the products split evenly over the
                   CHIPS ranks (bound_flops / CHIPS) against the rank's
                   own bytes (less its share of the unrouted experts)
  fits_each_card = the record's ``fits_each_card`` (a mesh) or
                   ``fits_one_card`` (one card), decided by the dry run

A measured step time over ``bound_s`` is at most 1.  The reference's
probe correction (``corrected``, from unrolled 1- and 2-layer lowerings)
is left out: the dry run counts every layer.

  python -m repro_torch.launch.roofline --dryrun dryrun.json --out roofline
"""
from __future__ import annotations

import argparse
import dataclasses
import json

# why a useful_ratio reads over 1 (a row's ``note``, a table's footnote)
OVER_ONE = ("the model FLOPs count work the counter does not: the embedding "
            "table inside N_active, the lookup term, elementwise terms")

PEAK_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores (H100 SXM)
PEAK_F32 = 67e12        # FLOP/s, f32 without TF32 (H100 SXM)
HBM_BW = 3.35e12        # B/s, HBM3 (H100 SXM)

LINK_BW = 50e9          # B/s, one 400 Gb/s NDR InfiniBand link a GPU
SERVE_ITEMSIZE = 2      # bytes of an LM serving weight (bf16, init_params)


def compute_peak(family: str) -> float:
    """The peak of an arch family's compute dtype: bf16 for the LMs, f32
    for the recsys models, DimeNet and has-rag."""
    return PEAK_BF16 if family == "lm" else PEAK_F32


def cell_config(arch: str, shape: str, variant: dict | None = None):
    """``(config, dims)`` of a cell with the dry run's variant applied:
    ``n_layers`` and ``global_batch`` for the LMs, ``corpus_size`` for
    has-rag (``n_micro`` changes no count)."""
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    cfg, dims = spec.config, dict(spec.shapes[shape].dims)
    v = variant or {}
    if v.get("n_layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=v["n_layers"])
    if v.get("global_batch") is not None:
        dims["global_batch"] = v["global_batch"]
    if v.get("corpus_size") is not None:
        cfg = dataclasses.replace(cfg, corpus_size=v["corpus_size"])
    return cfg, dims


def _model_flops(arch: str, shape: str, cfg=None, dims=None) -> float:
    """Analytic useful FLOPs for the whole step, term for term the
    reference's (``src/repro/launch/roofline.py:32-90``) over ``cfg`` and
    ``dims`` (default the registry's)."""
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    cfg = spec.config if cfg is None else cfg
    dims = spec.shapes[shape].dims if dims is None else dims
    if spec.family == "lm":
        c = cfg
        b, s = dims["global_batch"], dims["seq_len"]
        n_act = c.active_param_count()
        attn_fwd = 4 * b * c.n_layers * c.n_heads * c.d_head * (s ** 2) / 2
        if shape == "train_4k":
            return 6 * n_act * b * s + 3 * attn_fwd
        if shape == "prefill_32k":
            return 2 * n_act * b * s + attn_fwd
        # decode: one token against an s-long cache
        return 2 * n_act * b + 4 * b * c.n_layers * c.n_heads * c.d_head * s
    if spec.family == "gnn":
        d = dims
        c = cfg
        dh, nb, blocks = c.d_hidden, c.n_bilinear, c.n_blocks
        t, e = d["n_triplets"], d["n_edges"]
        per_block = 2 * t * nb * dh * dh + 2 * t * nb * dh \
            + 4 * e * dh * dh * 2
        fwd = blocks * per_block + 2 * d["n_nodes"] * d["d_feat"] * dh
        return 3 * fwd                                   # train
    if spec.family == "recsys":
        c = cfg
        d = dims
        b = d.get("batch", 1)
        lookup = b * c.n_sparse * c.embed_dim * 2
        if c.kind == "dlrm":
            mlps = sum(a * bb for a, bb in zip(
                (c.n_dense,) + c.bot_mlp[:-1], c.bot_mlp))
            n_inter = (c.n_sparse + 1) * c.n_sparse // 2
            mlps += sum(a * bb for a, bb in zip(
                (n_inter + c.bot_mlp[-1],) + c.top_mlp[:-1], c.top_mlp))
            fwd = b * mlps * 2 + b * (c.n_sparse + 1) ** 2 * c.embed_dim
        elif c.kind == "deepfm":
            mlps = sum(a * bb for a, bb in zip(
                (c.n_sparse * c.embed_dim,) + c.mlp, c.mlp + (1,)))
            fwd = b * mlps * 2 + b * c.n_sparse * c.embed_dim * 4
        elif c.kind == "autoint":
            per = c.n_sparse * (3 * c.embed_dim * c.d_attn * c.n_heads * 2
                                + 2 * c.n_sparse * c.d_attn * c.n_heads * 2)
            fwd = b * c.n_attn_layers * per
        else:  # bert4rec
            dd = c.embed_dim
            s = c.seq_len
            per = s * (12 * dd * dd) + 4 * s * s * dd
            fwd = b * (c.n_blocks * per + 2 * s * dd * c.total_vocab)
        if shape == "retrieval_cand":
            return 2 * d["n_candidates"] * c.embed_dim
        fwd += lookup
        return 3 * fwd if shape == "train_batch" else fwd
    if spec.family == "rag":
        c = cfg
        # full f32 scan + int8 fuzzy scan + cache channel, per query batch
        return 2 * c.corpus_size * c.d * 2 * c.query_batch
    return 0.0


def _bound_flops(arch: str, shape: str, cfg=None, dims=None) -> float:
    """The products a cell's step must do, for the bound (module
    docstring): :func:`_model_flops` less the work that is no product."""
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    cfg = spec.config if cfg is None else cfg
    dims = spec.shapes[shape].dims if dims is None else dims
    total = _model_flops(arch, shape, cfg, dims)
    if spec.family == "lm":
        c = cfg
        b, s = dims["global_batch"], dims["seq_len"]
        head = c.vocab_size * c.d_model
        # the embedding is gathered and the norm scales multiply elementwise
        not_mm = head + (2 * c.n_layers + 1) * c.d_model
        if shape == "train_4k":
            return total - 6 * not_mm * b * s
        if shape == "prefill_32k":
            # the unembed runs on the last position only
            return total - 2 * not_mm * b * s - 2 * head * b * (s - 1)
        return total - 2 * not_mm * b
    if spec.family == "recsys" and shape != "retrieval_cand":
        c = cfg
        b = dims.get("batch", 1)
        skip = b * c.n_sparse * c.embed_dim * 2                 # the lookup
        if c.kind == "deepfm":
            skip += b * c.n_sparse * c.embed_dim * 4     # FM, elementwise
        return total - (3 if shape == "train_batch" else 1) * skip
    return total            # DimeNet's and has-rag's terms are all products


def _unrouted_bytes(arch: str, shape: str, cfg=None) -> float:
    """The expert weights an MoE serving step need not read: the port's
    dispatch reads all E experts of a layer, and the least any routing
    reads is its top-k (the dry run has no tokens to route)."""
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    cfg = spec.config if cfg is None else cfg
    if spec.family != "lm" or not cfg.is_moe \
            or spec.shapes[shape].kind == "train":
        return 0.0
    return (cfg.n_layers * (cfg.moe_experts - cfg.moe_top_k)
            * 3 * cfg.d_model * cfg.d_ff * SERVE_ITEMSIZE)


def bound(rec: dict, family: str, bound_flops: float,
          unrouted: float = 0.0) -> tuple[float, str]:
    """(bound_s, bound_by) of a record, a least time a rank (module
    docstring)."""
    chips = rec.get("n_devices", 1)
    t_ops = bound_flops / chips / compute_peak(family)
    t_bytes = (rec["argument_read_bytes"] + rec["output_written_bytes"]
               - unrouted / chips) / HBM_BW
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def analyze(records: list[dict]) -> list[dict]:
    """One row per OK record, sorted by arch, shape and variant."""
    from repro_torch.configs import get_arch
    out = []
    for rec in records:
        if not rec.get("ok"):
            continue
        arch, shape = rec["arch"], rec["shape"]
        variant = rec.get("variant") or {}
        family = get_arch(arch).family
        by_dtype = rec.get("flops_by_dtype") or {}
        flops = rec.get("flops_per_device", 0.0) or 0.0
        low = sum(v for k, v in by_dtype.items()
                  if k in ("bfloat16", "float16"))
        t_comp = low / PEAK_BF16 + (flops - low) / PEAK_F32
        traffic = rec.get("bytes_per_device", 0.0) or 0.0
        t_mem = traffic / HBM_BW
        chips = rec.get("n_devices", 1)
        coll = float((rec.get("collectives") or {}).get("total", 0))
        t_coll = coll / LINK_BW
        terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
        dominant = max(terms, key=terms.get)
        step_time = max(terms.values())
        cfg, dims = cell_config(arch, shape, variant)
        mflops = _model_flops(arch, shape, cfg, dims)
        bflops = _bound_flops(arch, shape, cfg, dims)
        ratio = mflops / (flops * chips) if flops else 0.0
        frac = (mflops / chips / step_time) / compute_peak(family) \
            if step_time else 0.0
        bound_s, bound_by = bound(rec, family, bflops,
                                  _unrouted_bytes(arch, shape, cfg))
        out.append({
            "arch": arch, "shape": shape, "variant": variant,
            "mesh": rec.get("mesh", "1"), "chips": chips,
            "flops_per_chip": flops, "bytes_per_chip": traffic,
            "coll_bytes_per_chip": coll,
            "t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll,
            "dominant": dominant,
            "model_flops_total": mflops,
            "useful_ratio": ratio,
            "roofline_frac": frac if mflops else None,
            "bound_flops": bflops, "bound_s": bound_s, "bound_by": bound_by,
            "fits_each_card": rec.get("fits_each_card",
                                      rec.get("fits_one_card")),
            "note": OVER_ONE if ratio > 1 else "",
        })
    out.sort(key=lambda r: (r["arch"], r["shape"], r["chips"],
                            json.dumps(r["variant"], sort_keys=True)))
    return out


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute (s) | traffic (s) | collective (s) | "
           "dominant | useful FLOP ratio | roofline frac (predicted) | "
           "bound (s) | bound by |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        rf = f"{r['roofline_frac']:.3f}" if r["roofline_frac"] else "-"
        mark = "*" if r["note"] else ""
        shape = r["shape"] + "".join(f", {k}={v}" for k, v in
                                     sorted(r["variant"].items()))
        if r["chips"] > 1:
            shape += f" @ {r['mesh']}"
        lines.append(
            f"| {r['arch']} | {shape} | {r['t_compute_s']:.2e} "
            f"| {r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.3f}{mark} | {rf} "
            f"| {r['bound_s']:.4g} | {r['bound_by']} |")
    if any(r["note"] for r in rows):
        lines += ["", f"\\* {OVER_ONE}."]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun.json")
    ap.add_argument("--out", default="results/roofline")
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        records = json.load(f)
    rows = analyze(records)
    with open(args.out + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    with open(args.out + ".md", "w") as f:
        f.write(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
