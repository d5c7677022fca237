"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Each check runs in a fresh
interpreter; top-level module names are compared whole (``repro_torch``
begins with ``repro``)."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _run(code: str, tmp_path) -> dict:
    script = tmp_path / "probe.py"
    script.write_text(textwrap.dedent(code))
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_and_a_cpu_rehearsal_load_no_jax(tmp_path):
    got = _run(f"""
        import importlib, json, sys
        from pathlib import Path
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                        {str(ROOT / 'perfbench' / 'tests')!r}]
        from perfbench import harness
        root = Path({str(ROOT)!r})
        for p in sorted((root / "perfbench").rglob("*.py")):
            rel = p.relative_to(root)
            if "tests" in rel.parts:
                continue
            if p.parent.name in ("metrics", "stages"):
                harness.load_module(p, "probe_")
            else:
                importlib.import_module(".".join(rel.with_suffix("").parts))
        from conftest import make_tiny_bench
        dst = Path({str(tmp_path)!r}) / "bench"
        cell = make_tiny_bench(dst)
        out = harness.run_cell(harness.Bench(dst), cell, 7, 0.2, False,
                               device="cpu")
        print(json.dumps({{"mods": sorted({{m.split(".")[0]
                                            for m in sys.modules}}),
                          "correct": out["correct"]}}))
        """, tmp_path)
    assert got["correct"]
    assert "repro_torch" in got["mods"]
    assert not FORBIDDEN & set(got["mods"])


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    got = _run(f"""
        import importlib, json, sys
        from pathlib import Path
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        root = Path({str(ROOT)!r})
        for p in sorted((root / "perfbench" / "reference").glob("*.py")):
            importlib.import_module(
                ".".join(p.relative_to(root).with_suffix("").parts))
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """, tmp_path)
    assert "repro_torch" not in got
    assert not FORBIDDEN & set(got)
