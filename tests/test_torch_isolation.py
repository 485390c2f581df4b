"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, nothing is built or
loaded at import, and the entry points run on the GPU unless the caller
asks for the CPU — on a host with no GPU they raise rather than fall back.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.core, repro_torch.optim, "
            "repro_torch.train.loop, repro_torch.data.prefetch, "
            "repro_torch.launch.train, repro_torch.kernels.chunk_sum, "
            "repro_torch.kernels.quantize, repro_torch.kernels.fused_sgd, "
            "repro_torch.kernels.fused_rs_update, repro_torch.checkpoint, "
            "repro_torch.train.serve, repro_torch.fault, "
            "repro_torch.fault.smoke, repro_torch.telemetry.report, "
            "repro_torch.telemetry.validate; "
            "from repro_torch import kernels; "
            "assert not any(m.split('.')[0] in ('jax', 'repro') "
            "for m in sys.modules), sorted(sys.modules); "
            "assert not kernels._libs")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")


def test_build_model_without_device_raises_on_cpu_host():
    _no_gpu()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_smoke_config("llama3.2-1b"))


def test_training_without_device_raises_on_cpu_host():
    _no_gpu()
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_smoke_config("alexnet"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--smoke", "--ranks", "1", "--steps", "1"])


def test_engine_without_device_raises_on_cpu_host():
    _no_gpu()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    model = build_model(get_smoke_config("llama3.2-1b"), "cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params, max_slots=2, max_seq=32)
    Engine(model, params, max_slots=2, max_seq=32, device="cpu")


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CUDA device, or no checkout around it: a non-zero exit and no
    result line."""
    runs = [subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                           capture_output=True, text=True, timeout=120)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs.append(subprocess.run([sys.executable, str(alone)],
                               capture_output=True, text=True, timeout=120,
                               cwd=tmp_path))
    for r in runs[int(torch.cuda.is_available()):]:
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_fault_smoke_without_device_raises_on_cpu_host():
    _no_gpu()
    from repro_torch.fault import smoke
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.main(["--steps", "1"])
