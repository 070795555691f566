"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is a plain C interface compiled by ``nvcc`` for
``sm_90a`` into a shared library on first use, then loaded with ``ctypes``.
Libraries go to ``metrics_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and flags so an edited source never loads a
stale build. Nothing here runs at import time; where ``nvcc`` is missing the
build raises.

``LOAD_HOOK`` is the loader's counting hook: when set (by
``observability/compilemon.py``), every library a process loads reports
``(name, hit, seconds)``, ``hit`` when the library was found built.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# (name, found built, seconds to make it ready) for every library loaded; None: no counting
LOAD_HOOK: Optional[Callable[[str, bool, float], None]] = None


class KernelLibraries:
    """The built and loaded kernel libraries of this process, with their build records."""

    def __init__(self) -> None:
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds: Dict[str, float] = {}
        self.build_log: Dict[str, str] = {}

    def load(self, name: str, force: bool = False) -> ctypes.CDLL:
        """The loaded library for ``csrc/<name>.cu``; ``force`` rebuilds it from source."""
        if force or name not in self.libs:
            t0 = time.perf_counter()
            path, built = self._build(name, force)
            self.libs[name] = ctypes.CDLL(str(path))
            hook = LOAD_HOOK
            if hook is not None:
                hook(name, not built, time.perf_counter() - t0)
        return self.libs[name]

    def build(self, name: str, force: bool = False) -> Path:
        return self._build(name, force)[0]

    def _build(self, name: str, force: bool = False) -> Tuple[Path, bool]:
        """The library's path, and whether ``nvcc`` ran for it now."""
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists() and not force:
            return out, False
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads a half-written library
        self.build_seconds[name] = time.perf_counter() - t0
        self.build_log[name] = proc.stdout + proc.stderr
        return out, True


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME`` (default ``/usr/local/cuda``) or ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels build on the GPU machine")
    return found


KERNELS = KernelLibraries()
