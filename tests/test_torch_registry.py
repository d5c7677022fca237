"""The port's config registry (``repro_torch.configs``) against the
reference's (``repro.configs``): the same eleven archs, each with the
reference's family, source tag and shape specs, the same full configs
where both packages can compare them, and a smoke that builds on the CPU
when asked for it (CUDA is the default)."""
import dataclasses

import pytest
import torch

import repro.configs as rconfigs
import repro_torch.configs as pconfigs

ARCHS = rconfigs.all_archs()


def _shapes(spec):
    return {k: (v.name, v.kind, dict(v.dims), v.note)
            for k, v in spec.shapes.items()}


def test_all_archs_equal_reference():
    assert pconfigs.all_archs() == ARCHS
    assert len(ARCHS) == 11
    assert sorted(pconfigs.REGISTRY) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference(arch):
    want, got = rconfigs.get_arch(arch), pconfigs.get_arch(arch)
    assert (got.name, got.family, got.source) == \
        (want.name, want.family, want.source)
    assert _shapes(got) == _shapes(want)
    assert isinstance(next(iter(got.shapes.values())), pconfigs.ShapeSpec)
    # the full config, field for field (dtypes by name: jnp and torch)
    rc, pc = want.config, got.config
    assert type(pc).__name__ == type(rc).__name__
    names = {f.name for f in dataclasses.fields(rc)} \
        & {f.name for f in dataclasses.fields(pc)}
    for f in sorted(names):
        a, b = getattr(pc, f), getattr(rc, f)
        if isinstance(a, torch.dtype):
            assert str(a).split(".")[-1] == b.__name__, (arch, f)
        else:
            assert a == b, (arch, f)
    if hasattr(rc, "param_count"):
        assert pc.param_count() == rc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_builds_on_cpu(arch):
    out = pconfigs.get_arch(arch).make_smoke(device="cpu")
    if arch == "has-rag":
        cfg, fn, args = out
        ids, accept, best = fn(*args)
        assert tuple(ids.shape) == (args[-1].shape[0], cfg.k)
        return
    cfg, params, opt_state, step, batch = out
    assert all(t.device.type == "cpu" for t in batch.values())
    _, _, metrics = step(params, opt_state, batch)
    assert torch.isfinite(metrics["loss"])
