"""``utils/cuda_build.py`` on the CPU, with a stand-in for nvcc (a shell
script that writes the library and prints what ptxas would): each build's
compiler output is kept beside its library and handed back on every later
call, so a check of ptxas's warnings reads real output even when the
library was built by an earlier run."""

import os
import stat

import pytest

from tensorflow_yolo2_torch.utils import cuda_build

FAKE_NVCC = """#!/bin/sh
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"; src="$a"
done
echo "$src" >> "$(dirname "$0")/calls"
if grep -q '#error' "$src"; then echo "$src: error: stop"; exit 1; fi
echo "ptxas info    : Used 8 registers"
grep -q serialize "$src" && echo "ptxas warning : wgmma serialized"
printf lib > "$out"
"""


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """A fake CUDA_HOME and build directory; returns the file that lists
    the sources nvcc was called on."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    script = bindir / "nvcc"
    script.write_text(FAKE_NVCC)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    return bindir / "calls"


def test_build_keeps_compiler_output(nvcc, tmp_path):
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// a\n")
    b.write_text("// b, serialize\n")
    logs = cuda_build.build([str(a), str(b)])
    assert "Used 8 registers" in logs[str(a)]
    assert "serialized" in logs[str(b)] and "serialized" not in logs[str(a)]
    assert sorted(nvcc.read_text().split()) == [str(a), str(b)]
    for src in (a, b):
        lib = cuda_build.library_path(str(src))
        assert os.path.basename(lib).startswith(f"lib{src.stem}-")
        assert open(lib).read() == "lib"
        assert open(lib[:-3] + ".log").read() == logs[str(src)]
    # built: no nvcc, the same output
    assert cuda_build.build([str(b), str(a)]) == logs
    assert len(nvcc.read_text().split()) == 2
    # a library whose output is lost is built again
    os.unlink(cuda_build.library_path(str(a))[:-3] + ".log")
    assert "Used 8 registers" in cuda_build.build([str(a)])[str(a)]
    assert len(nvcc.read_text().split()) == 3
    # an edited source is a new library
    a.write_text("// a, edited\n")
    cuda_build.build([str(a)])
    assert len(nvcc.read_text().split()) == 4


def test_build_failure_leaves_nothing(nvcc, tmp_path):
    bad = tmp_path / "bad.cu"
    bad.write_text("#error no\n")
    with pytest.raises(RuntimeError, match="nvcc failed for .*bad.cu"):
        cuda_build.build([str(bad)])
    assert os.listdir(cuda_build.BUILD_DIR) == []


def test_source_names():
    assert cuda_build.source_path("stem") == os.path.join(
        cuda_build.CSRC_DIR, "stem.cu")
    assert cuda_build.source_path("/x/y.cu") == "/x/y.cu"
    assert os.path.basename(cuda_build.library_path("stem")).startswith(
        "libstem-")
    assert {"decode", "pool", "stem"} <= set(cuda_build.sources())
