"""The kernel build's log, which chip_smoke.py reads, on a machine without
nvcc: a stand-in compiler that writes an empty object takes the place of
nvcc, and a mock takes the place of the loaded library. Each source gets
its own section of the log (ptxas's report, found by ``== source``), and
the last section says when each source's nvcc ended, which
``KernelLibrary.source_seconds`` reads back."""

import stat
from unittest import mock

import pytest

pytest.importorskip("torch")

from protein_redesign_tpu_torch import kernels  # noqa: E402

FAKE_NVCC = """#!/bin/sh
out=""
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
case "$out" in *attention_tf32.o) sleep 1 ;; esac
for src in "$@"; do :; done
echo "ptxas info : report for $(basename "$src")"
: > "$out"
"""


def test_build_log_records_each_sources_nvcc_end(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_LIBRARY", None)
    monkeypatch.setattr(kernels.ctypes, "CDLL", mock.MagicMock())
    lib = kernels.build()
    assert lib.build_seconds is not None and lib.path.parent == tmp_path / "_build"
    for src in kernels.SOURCES:
        section = lib.build_log.split(f"== {src}\n", 1)[1].split("\n== ", 1)[0]
        assert section.startswith(f"ptxas info : report for {src}")
    assert lib.build_log.count(kernels.NVCC_SECONDS) == 1
    assert list(lib.source_seconds) == list(kernels.SOURCES)
    # written to a tenth of a second
    assert all(0 <= s <= lib.build_seconds + 0.05 for s in lib.source_seconds.values())
    assert lib.source_seconds["attention_tf32.cu"] >= 1.0
    assert max(lib.source_seconds, key=lib.source_seconds.get) == "attention_tf32.cu"
    # a second process reuses the library and reads the same times from its log
    monkeypatch.setattr(kernels, "_LIBRARY", None)
    again = kernels.build()
    assert again.build_seconds is None and again.source_seconds == lib.source_seconds
