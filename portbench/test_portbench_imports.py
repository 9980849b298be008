"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``rife_tpu_torch`` is not ``rife_tpu``."""

import ast
import subprocess
import sys

from portbench import harness, testing

FORBIDDEN = {"jax", "jaxlib", "flax", "rife_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted(harness.PKG.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        if "_work" in path.parts:
            continue
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path}: imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((harness.PKG / "reference").rglob("*.py")):
        assert "rife_tpu_torch" not in set(_imports(path)), path
    for dep in ("ncnn.py",):
        assert "rife_tpu_torch" not in set(_imports(harness.PKG / dep))


def test_whole_names():
    import sys as s

    s.modules.setdefault("rife_tpu_torch_probe", object())
    try:
        assert "rife_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del s.modules["rife_tpu_torch_probe"]


def test_mini_run_loads_no_jax(tmp_path):
    """A whole mini run in a fresh process, then its ``sys.modules``."""
    code = (
        "import sys\n"
        "from portbench import testing, harness\n"
        "c = testing.mini_cell('v23-1080p-b8-device', traced=True)\n"
        f"testing.run(c, {str(tmp_path)!r})\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n"
        "print('PROGRAM', 'rife_tpu_torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=testing.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout
    assert "PROGRAM True" in proc.stdout
