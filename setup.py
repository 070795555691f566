#!/usr/bin/env python
"""Packaging for metrics_tpu (reference L0: setup.py + torchmetrics/info.py) and its
PyTorch/CUDA port metrics_tpu_torch, which ships its CUDA sources (csrc/*.cu) to build on first use."""
import os

from setuptools import find_packages, setup

_PATH_ROOT = os.path.dirname(__file__)


def _load_py_module(fname: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location("info", os.path.join(_PATH_ROOT, "metrics_tpu", fname))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


info = _load_py_module("info.py")

setup(
    name="metrics_tpu",
    version=info.__version__,
    description=info.__docs__,
    author=info.__author__,
    license=info.__license__,
    packages=find_packages(exclude=["tests", "tests.*"]),
    package_data={"metrics_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.9",
    install_requires=["jax>=0.4.30", "numpy"],
    extras_require={"test": ["pytest", "scikit-learn", "scipy", "nltk"], "torch": ["torch"]},
)
