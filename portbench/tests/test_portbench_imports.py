"""Nothing a run loads is JAX or the JAX package, by whole top-level
module name; the reference loads nothing of the port either."""

import ast
import pathlib
import subprocess
import sys

from portbench import harness

REFERENCE = harness.BENCH_DIR / "reference"
TIMEOUT = 600


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.split()


def test_a_run_loads_no_jax_module():
    """A whole run of each cell at the tests' size, then the process's
    modules by top-level name."""
    loaded = _run(
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "from tiny import tiny_cell, run\n"
        "run(tiny_cell('vcr_base.q2a_pixels_b16'))\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "vlbert_tpu_torch" in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _run(
        "import sys\n"
        "import portbench.reference.model, portbench.reference.step\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(loaded) & (set(harness.FORBIDDEN) | {"vlbert_tpu_torch"})


def test_the_reference_sources_import_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(pathlib.Path(path).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in harness.FORBIDDEN + ("vlbert_tpu_torch",), \
                    (path, n)
                assert top in ("torch", "portbench", "__future__", "math",
                               "re", "contextlib"), (path, n)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["vlbert_tpu_torch.models", "jaxtyping", "flaxen", "torch"]) == []
    assert harness.forbidden_modules(
        ["vlbert_tpu.models.bert", "jax._src", "optax"]) == [
            "jax", "optax", "vlbert_tpu"]
