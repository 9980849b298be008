"""The port stands alone: no module of ``rife_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package or jax, a session step on the CPU
leaves neither in ``sys.modules``, the port reads no ``RIFE_TPU_*``
environment variable, and a session runs on the card unless the caller asks
for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "rife_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
              REPO / "tools" / "torch_step_profile.py"]
    if "_build" not in p.parts)
FORBIDDEN = ("rife_tpu", "jax", "jaxlib")


def imported_modules(tree):
    """Absolute module names a module's import statements name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    assert "chip_smoke.py" in PORT_FILES
    assert "rife_tpu_torch/graph/rewrite.py" in PORT_FILES
    assert len(PORT_FILES) >= 20


@pytest.mark.parametrize("path", PORT_FILES)
def test_imports_nothing_of_the_jax_package(path):
    tree = ast.parse((REPO / path).read_text())
    for name in imported_modules(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def env_reads(tree):
    """String keys passed to os.environ.get / os.getenv / os.environ[...]."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if name in ("get", "getenv", "pop", "setdefault"):
                yield node.args[0].value
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Attribute)
              and node.value.attr == "environ"
              and isinstance(node.slice, ast.Constant)):
            yield node.slice.value


@pytest.mark.parametrize("path", PORT_FILES)
def test_reads_no_rife_tpu_variable(path):
    tree = ast.parse((REPO / path).read_text())
    for key in env_reads(tree):
        assert not str(key).startswith("RIFE_TPU_"), f"{path} reads {key}"


STEP = (
    "import sys, numpy as np\n"
    "from rife_tpu_torch import RIFE\n"
    "from rife_tpu_torch.models.{mod} import {fn}\n"
    "d = {fn}(sys.argv[1], {widths})\n"
    "s = RIFE(str(d), device='cpu')\n"
    "rng = np.random.default_rng(0)\n"
    "a = rng.integers(0, 256, (1, 32, 64, 3), np.uint8)\n"
    "o = s.process_batch(a, a[:, ::-1].copy(), np.array([0.5], np.float32))\n"
    "assert o.shape == (1, 32, 64, 3)\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('rife_tpu', 'jax', 'jaxlib'))\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)


@pytest.mark.parametrize("mod,fn,widths", [
    ("v23_arch", "write_v23_params", (8, 8, 8, 8, 4)),
    ("v46_arch", "write_flownet_param", (16, 16, 16, 16)),
])
def test_session_step_loads_neither_jax_nor_rife_tpu(tmp_path, mod, fn,
                                                     widths):
    code = STEP.format(mod=mod, fn=fn, widths=widths)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # several test processes run at once
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_session_defaults_to_the_card(tmp_path):
    """``RIFE(model)`` asks for CUDA: without a card it raises, and the CPU
    runs only when asked."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.models.v23_arch import write_v23_params

    d = str(write_v23_params(tmp_path, (8, 8, 8, 8, 4)))
    if torch.cuda.is_available():
        assert RIFE(d).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            RIFE(d)
    assert RIFE(d, device="cpu").device.type == "cpu"
