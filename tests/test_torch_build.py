"""The port's kernel build (``ops/_build.py``) on the CPU, with a stand-in
for ``nvcc``: one compile per ``csrc/*.cu``, one link of all objects, a
library name keyed on every source and header, and no process left behind when a
compile fails.  (The real ``nvcc`` exists only on the GPU machine.)"""

from __future__ import annotations

import os
import stat
import time

import pytest

from kubernetes_deep_learning_tpu_torch.ops import _build

# Appends its arguments to $FAKE_NVCC_LOG and creates the -o file; fails
# for a source named bad.cu.
_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$FAKE_NVCC_LOG"
case "$*" in *bad.cu*) echo "bad.cu: error"; exit 2;; esac
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
: > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "build"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return csrc, log


def test_build_compiles_every_source_and_links_one_library(fake_tree):
    csrc, log = fake_tree
    target = _build._library_path()
    assert os.path.basename(target).startswith("kdlt_kernels-")
    _build._compile(target)
    assert os.path.exists(target)
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split()[-1] for c in compiles) == [str(csrc / "a.cu"), str(csrc / "b.cu")]
    (link,) = [c for c in calls if "-shared" in c.split()]
    assert sum(w.endswith(".o") for w in link.split()) == 2
    assert not [f for f in os.listdir(os.path.dirname(target)) if f.endswith(".o")]


def test_library_name_keys_on_every_source(fake_tree):
    csrc, _ = fake_tree
    first = _build._library_path()
    (csrc / "b.cu").write_text("// b, edited\n")
    second = _build._library_path()
    (csrc / "c.cu").write_text("// c\n")
    assert len({first, second, _build._library_path()}) == 3


def test_library_name_keys_on_every_header(fake_tree):
    """A source's ``#include "x.cuh"`` is part of what it compiles to: an
    edited or added header names a new library, and is not compiled alone."""
    csrc, log = fake_tree
    (csrc / "shared.cuh").write_text("// shared\n")
    first = _build._library_path()
    (csrc / "shared.cuh").write_text("// shared, edited\n")
    second = _build._library_path()
    (csrc / "more.cuh").write_text("// more\n")
    third = _build._library_path()
    assert len({first, second, third}) == 3
    _build._compile(third)
    compiled = [c.split()[-1] for c in log.read_text().splitlines() if " -c " in f" {c} "]
    assert not [c for c in compiled if c.endswith(".cuh")]


def test_failed_compile_raises_and_stops_the_others(fake_tree):
    csrc, _ = fake_tree
    (csrc / "bad.cu").write_text("// does not compile\n")
    slow = _build._start(["sleep", "30"])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="bad.cu: error"):
        _build._run([_build._start([_build._nvcc(), "-c", "-o", "/dev/null",
                                    str(csrc / "bad.cu")]), slow])
    assert slow[1].poll() is not None and time.monotonic() - t0 < 20
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._compile(_build._library_path())
