"""The port's training entry points on the CPU: the ``train`` CLI
(``repro_torch.launch.train``), ``train_lm`` with checkpoints and resume,
the ``train_lm`` twin, and the Markov LM source against the reference's.

``--arch`` runs each registered arch's reduced config (the twin of
``tests/test_models.py::test_arch_smoke``: a finite loss, parameters
changed): the LM archs here, the recsys archs and DimeNet through the
CLI; ``has-rag``, a retrieval step with no train step, raises.  A run resumed from a checkpoint trains on
the batches an uninterrupted run would, so its losses equal that run's
(within ``RESUME_RTOL``).  ``MarkovLM`` draws the reference's table and
tokens (md5 digests pinned in ``data/digests.py``, computed with the
reference under numpy 2.0.2).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import families as rfam
from repro.configs import lm_archs as rarchs
from repro.data import lm as rlm
from repro_torch.configs.families import lm_opt_config, lm_shapes, lm_smoke
from repro_torch.configs.lm_archs import LM_CONFIGS
from repro_torch.data import digests
from repro_torch.data import lm as plm
from repro_torch.launch import train
from repro_torch.models.transformer import TransformerConfig

ROOT = Path(__file__).resolve().parents[1]
# a resumed run against an uninterrupted one: the same f32 losses, up to
# the order in which the CPU's matrix products add (it may change between
# calls with the buffers' alignment)
RESUME_RTOL = 1e-5
TINY = TransformerConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                         n_kv_heads=2, d_ff=64, vocab_size=64, d_head=8,
                         remat=False)


@pytest.mark.parametrize("arch", sorted(LM_CONFIGS))
def test_arch_cli_smoke(arch):
    losses = train.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg, params, opt_state, step, batch = lm_smoke(LM_CONFIGS[arch], "cpu")
    before = [t.clone() for t in params["layers"][0]["attn"].values()]
    params, _, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, params["layers"][0]["attn"].values()))
    if cfg.is_moe:
        assert params["layers"][0]["moe"]["router"].dtype == torch.float32


def test_train_shape_and_optimizer_match_reference():
    """``train_4k`` as the reference's shape set has it, and each LM
    arch's optimizer as the reference's family glue picks it."""
    assert {k: (v.name, v.kind, dict(v.dims), v.note)
            for k, v in lm_shapes().items()} == \
        {k: (v.name, v.kind, dict(v.dims), v.note)
         for k, v in rfam.lm_shapes().items()}
    for arch, cfg in LM_CONFIGS.items():
        assert lm_opt_config(cfg).name == \
            rfam.lm_opt_config(rarchs.LM_CONFIGS[arch]).name, arch


@pytest.mark.parametrize("arch", ["autoint", "bert4rec", "deepfm",
                                  "dimenet", "dlrm-rm2"])
def test_other_family_arch_cli_smoke(arch, capsys):
    """The recsys archs and DimeNet through the registry: finite losses
    that fall over the smoke's repeated batch."""
    losses = train.main(["--arch", arch, "--steps", "12", "--device",
                         "cpu"])
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert f"[train] {arch} step 10 loss" in out and "[train] done" in out


def test_has_rag_arch_raises():
    """The reference fails here too (its ``main`` unpacks the smoke's
    three values into five); the port says why."""
    with pytest.raises(ValueError, match="no train step"):
        train.main(["--arch", "has-rag", "--steps", "1", "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown arch"):
        train.main(["--arch", "no-such-arch", "--device", "cpu"])


def test_train_lm_resume_reproduces_uninterrupted_run(tmp_path, capsys):
    whole = train.train_lm(TINY, 60, 4, 32, None, device="cpu")
    assert np.mean(whole[-10:]) < np.mean(whole[:10])       # the loss falls
    first = train.train_lm(TINY, 50, 4, 32, str(tmp_path), device="cpu")
    resumed = train.train_lm(TINY, 60, 4, 32, str(tmp_path), device="cpu")
    assert "[train] resumed from step 50" in capsys.readouterr().out
    np.testing.assert_allclose(first, whole[:50], rtol=RESUME_RTOL)
    np.testing.assert_allclose(resumed, whole[50:], rtol=RESUME_RTOL)


def test_train_lm_checkpoints_bf16_masters(tmp_path):
    """A bf16 config's masters and Adafactor state survive the checkpoint
    bit for bit (numpy has no bf16: they go through as int16 bits)."""
    import dataclasses
    cfg = dataclasses.replace(TINY, moe_experts=4, param_dtype=torch.bfloat16)
    whole = train.train_lm(cfg, 4, 2, 16, None, device="cpu")
    train.train_lm(cfg, 2, 2, 16, str(tmp_path), device="cpu")
    np.testing.assert_allclose(
        train.train_lm(cfg, 4, 2, 16, str(tmp_path), device="cpu"),
        whole[2:], rtol=RESUME_RTOL)


def test_train_example_runs(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    losses = twin.main(["--steps", "5", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert "training lm20m" in capsys.readouterr().out
    assert twin.main(["--steps", "5", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path)]) == []          # resumed at its end


@pytest.mark.parametrize("size", sorted(digests.MARKOV_SIZES))
def test_markov_source_matches_pinned_digests(size):
    """The pins are the reference's draw here, and the port draws them."""
    assert digests.markov_digests(rlm.MarkovLM, size) == \
        digests.MARKOV_PINNED[size]
    assert digests.markov_digests(plm.MarkovLM, size) == \
        digests.MARKOV_PINNED[size]


def test_markov_batches_match_reference():
    ref = list(rlm.batches(97, 3, 20, 4, seed=5))
    got = list(plm.batches(97, 3, 20, 4, seed=5))
    for r, g in zip(ref, got):
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], r[k])
