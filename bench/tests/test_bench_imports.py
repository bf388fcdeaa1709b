"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: `repro_torch` is not `repro`."""

import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax(root):
    names = _top_level_after(
        "from pathlib import Path\nfrom bench import run, harness\n"
        f"c = harness.cell('features.covariates', root=Path('{root}'))\n"
        "r = harness.run(c, 5, 0.2, True, device='cpu', sizes={'n_samples':"
        " 300, 'n_features': 64, 'n_perms': 19, 'call': {'materialize':"
        " 'fused-kernel'}})\n"
        f"c = harness.cell('emp-matrix.strata', root=Path('{root}'))\n"
        "r = harness.run(c, 5, 0.2, False, device='cpu', sizes={'n_samples':"
        " 300, 'n_features': 64, 'n_perms': 19})\n"
        "for m in c.per_layer: harness.module('metrics', m)\n")
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level_after("import bench.reference.permanova")
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_run_py_names_the_forbidden_modules():
    from bench import run
    assert set(run.FORBIDDEN) == FORBIDDEN
