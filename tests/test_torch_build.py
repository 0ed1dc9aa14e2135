"""The port's kernel build (horovod_tpu_torch/ops/_build.py) on the CPU.

The CPU tests run without nvcc, so a stand-in compiler (a shell script
that logs its call and writes the output file, or fails) shows what the
build does around nvcc: a library is keyed by the hash of its source
and flags, an unchanged source is not compiled again, an edited one is,
every stale source gets its own compiler process, and a failed or
impossible build raises instead of leaving the wrappers another path.
"""

import stat

import pytest

from horovod_tpu_torch.ops import _build

OK_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  last="$1"
  shift
done
echo "$last" >> "{log}"
echo "ptxas info    : Used 32 registers"
: > "$out"
"""

BAD_NVCC = """#!/bin/sh
echo "error: identifier undefined" >&2
exit 2
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _fake_nvcc(tree, monkeypatch, body):
    path = tree / "nvcc"
    path.write_text(body.format(log=tree / "calls.log"))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(path))


def _calls(tree):
    log = tree / "calls.log"
    return log.read_text().split() if log.exists() else []


def test_builds_each_stale_source_once_and_again_when_edited(tree,
                                                             monkeypatch):
    _fake_nvcc(tree, monkeypatch, OK_NVCC)
    assert _build.sources() == ["a", "b"]
    logs = _build.build()
    assert sorted(logs) == ["a", "b"]
    assert "registers" in logs["a"]
    assert sorted(_calls(tree)) == sorted(
        str(tree / "csrc" / f"{n}.cu") for n in "ab")
    assert _build.library_path("a").exists()
    assert _build.build() == {}               # up to date: no compile
    old = _build.library_path("a")
    (tree / "csrc" / "a.cu").write_text("// a, edited\n")
    assert _build.library_path("a") != old
    assert sorted(_build.build()) == ["a"]
    assert len(_calls(tree)) == 3


def test_a_failed_compile_raises_with_the_compiler_output(tree,
                                                          monkeypatch):
    _fake_nvcc(tree, monkeypatch, BAD_NVCC)
    with pytest.raises(RuntimeError, match="identifier undefined"):
        _build.build(["a"])
    assert not _build.library_path("a").exists()


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
