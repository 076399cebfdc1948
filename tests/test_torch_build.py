"""The kernel build of the port (`jlama_tpu_torch/ops/_build.py`) with a stand-in
compiler: parallel builds, the content hash that keys a built library, and a
failed compile that raises with the compiler's output and leaves nothing
behind. The real nvcc runs only on a machine with the CUDA toolkit."""

import sys

import pytest

from jlama_tpu_torch.ops import _build

# stand-in for `nvcc <flags> -o OUT SRC`: copies SRC to OUT; a source that
# holds FAIL writes a partial OUT and fails, as a compiler may
FAKE_NVCC = """
import shutil, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
shutil.copy(src, out)
if "FAIL" in open(src).read():
    print(src + ": error: FAIL")
    sys.exit(2)
print("ptxas info    : Used 10 registers")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    fake = tmp_path / "fake_nvcc.py"
    fake.write_text(FAKE_NVCC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (str(fake),))
    return csrc, build


def test_builds_in_parallel_and_keys_by_content(fake_tree):
    csrc, build = fake_tree
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    times = _build.build(("a", "b"))
    assert set(times) == {"a", "b"}
    lib_a = _build.lib_path("a")
    assert lib_a.read_text() == "// a\n" and _build.lib_path("b").exists()
    assert "registers" in (build / "a.log").read_text()
    assert _build.build(("a", "b")) == {}  # built already: nothing to do
    (csrc / "a.cu").write_text("// a, edited\n")
    assert _build.lib_path("a") != lib_a
    assert set(_build.build(("a", "b"))) == {"a"}


def test_failed_compile_raises_with_the_log(fake_tree):
    csrc, build = fake_tree
    (csrc / "ok.cu").write_text("// ok\n")
    (csrc / "bad.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match=r"nvcc failed for \['bad'\](.|\n)*error: FAIL"):
        _build.build(("ok", "bad"))
    assert _build.lib_path("ok").exists()
    assert not _build.lib_path("bad").exists()
    assert sorted(p.name for p in build.iterdir()) == sorted(
        ["bad.log", "ok.log", _build.lib_path("ok").name])


def test_launch_error_raises():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="k: CUDA error 700"):
        _build.check(700, "k")
