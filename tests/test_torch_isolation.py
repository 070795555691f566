"""The port stands alone: no JAX, no ``metrics_tpu``, and no silent CPU fallback.

* An AST scan over ``metrics_tpu_torch/**.py`` and ``chip_smoke.py`` finds no
  import of ``jax`` or ``metrics_tpu``.
* A subprocess in which ``import jax`` fails imports the port and runs one
  CPU update.
* With CUDA unavailable, a metric built without ``device="cpu"`` raises, and
  an input on another device than the states raises.
"""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import metrics_tpu_torch as pt
from metrics_tpu_torch.utils.exceptions import DeviceMismatchError, NoDeviceError

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "metrics_tpu")


def _port_sources():
    return sorted((_REPO / "metrics_tpu_torch").rglob("*.py")) + [_REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference_package():
    sources = _port_sources()
    assert len(sources) > 20 and all(p.exists() for p in sources)
    offending = {str(p.relative_to(_REPO)): root for p in sources for root in _imported_roots(p) if root in _FORBIDDEN}
    assert not offending


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        sys.modules["metrics_tpu"] = None
        sys.path.insert(0, {str(_REPO)!r})
        import torch
        import metrics_tpu_torch as pt
        m = pt.Accuracy(device="cpu")
        m.update(torch.tensor([0, 1, 1]), torch.tensor([0, 1, 0]))
        print(float(m.compute()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == float(torch.tensor(2 / 3, dtype=torch.float32))


def test_default_device_is_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: pt.Accuracy(), lambda: pt.BinnedAUROC(), lambda: pt.F1(num_classes=3, device="cuda")):
        with pytest.raises(NoDeviceError, match="device='cpu'"):
            build()
    assert pt.Accuracy(device="cpu").device == torch.device("cpu")


def test_input_on_another_device_raises():
    m = pt.Accuracy(device="cpu")
    m.device = torch.device("meta")  # stands in for a GPU-resident metric
    with pytest.raises(DeviceMismatchError):
        m.update(torch.tensor([0, 1]), torch.tensor([0, 1]))
    with pytest.raises(DeviceMismatchError):
        m(torch.tensor([0, 1]), torch.tensor([0, 1]))


def test_importing_the_port_builds_no_kernel():
    from metrics_tpu_torch.ops.build import KERNELS

    assert KERNELS.libs == {} and KERNELS.build_seconds == {}
