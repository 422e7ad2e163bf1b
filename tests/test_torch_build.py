"""The port's kernel build (``torchmetrics_tpu_torch/ops/_build.py``), on the CPU without ``nvcc``.

What needs the compiler runs on the card (``chip_smoke.py``); here the build's own decisions
are checked: where a library goes, when it is rebuilt, and how a missing or failing compiler
is reported.
"""
from __future__ import annotations

import subprocess
import sys

import pytest

from torchmetrics_tpu_torch.ops import _build


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_source_and_flags(monkeypatch):
    path = _build.library_path("bincount")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libbincount-") and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("bincount") != path


def test_built_library_is_not_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.library_path("bincount").write_bytes(b"")

    def no_compiler(*args, **kwargs):
        raise AssertionError("a built library must not be compiled again")

    monkeypatch.setattr(subprocess, "Popen", no_compiler)
    assert _build.build(["bincount"]) >= 0.0


def test_compiler_failure_raises_with_its_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)  # rejects nvcc's flags and exits non-zero
    with pytest.raises(RuntimeError, match="nvcc failed for bincount.cu"):
        _build.build(["bincount"])
    assert not _build.library_path("bincount").exists()


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    # an edit to a shared header (csrc/*.cuh) must rebuild every source that may include it
    for path in (*_build.CSRC_DIR.glob("*.cu"), *_build.CSRC_DIR.glob("*.cuh")):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path("bincount")
    (tmp_path / "device_cache.cuh").write_text((tmp_path / "device_cache.cuh").read_text() + "\n// edited\n")
    assert _build.library_path("bincount") != before
