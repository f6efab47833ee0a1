"""The port's kernel build (``ops/_kernels.py``) without a CUDA toolkit.

A stand-in ``nvcc`` (a shell script found through ``CUDA_HOME``) writes
the file named by ``-o`` after a pause, or fails on request, so the
build's caching, its parallel start and its error path run on the CPU.
The real compiler and the kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import pathlib
import re
import stat
import time

import pytest

from mpi4torch_tpu_torch.ops import _kernels

CSRC = pathlib.Path(_kernels._CSRC)

FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
if grep -q FAIL "$src"; then echo "error in $src"; exit 3; fi
sleep 2
echo "ptxas info: 0 bytes spill stores for $src"
echo built > "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// kernel {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "_CSRC", str(csrc))
    monkeypatch.setattr(_kernels, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_kernels, "_SOURCES", {"a": "a.cu", "b": "b.cu"})
    monkeypatch.setattr(_kernels, "build_log", {})
    return csrc


def test_sources_compile_together_then_come_from_the_cache(fake_toolkit):
    t0 = time.perf_counter()
    paths = _kernels._compile(["a", "b"])
    seconds = time.perf_counter() - t0
    # Each stand-in compiler pauses 2 s; started together they end in
    # well under the 4 s that one after the other would take.
    assert seconds < 3.5
    assert sorted(paths) == ["a", "b"]
    for name, path in paths.items():
        assert os.path.basename(path).startswith(f"lib{name}_")
        assert open(path).read() == "built\n"
        assert "spill" in _kernels.build_log[name]["output"]
        assert _kernels.build_log[name]["seconds"] > 0
    assert not [f for f in os.listdir(os.path.dirname(paths["a"]))
                if f.endswith(".tmp")]
    again = _kernels._compile(["a", "b"])
    assert again == paths
    assert all(_kernels.build_log[n] == {"seconds": 0.0, "output": "cached"}
               for n in paths)


def test_an_edited_source_gets_a_new_library(fake_toolkit):
    first = _kernels._compile(["a"])["a"]
    (fake_toolkit / "a.cu").write_text("// kernel a, edited\n")
    second = _kernels._compile(["a"])["a"]
    assert second != first and os.path.exists(second)


def _extern_c_functions(path):
    """name -> parameter kinds ("pointer", "int", "long long") of every
    ``extern "C"`` function defined in a CUDA source."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', text):
        kinds = []
        for param in m.group(2).split(","):
            param = " ".join(param.split())
            if "*" in param:
                kinds.append("pointer")
            elif re.match(r"(const )?long long \w+$", param):
                kinds.append("long long")
            elif re.match(r"(const )?int \w+$", param):
                kinds.append("int")
            else:
                kinds.append(f"unknown: {param}")
        found[m.group(1)] = kinds
    return found


_CTYPE_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_longlong: "long long"}
_SOURCE_FUNCTIONS = [
    (lib, fn) for lib, src in sorted(_kernels._SOURCES.items())
    for fn in sorted(_extern_c_functions(CSRC / src))]


def test_every_library_exports_what_its_signatures_name():
    assert sorted(_kernels._SOURCES) == sorted(_kernels._SIGNATURES)
    for lib, src in _kernels._SOURCES.items():
        assert sorted(_extern_c_functions(CSRC / src)) == \
            sorted(_kernels._SIGNATURES[lib]), lib


@pytest.mark.parametrize("lib, fn", _SOURCE_FUNCTIONS,
                         ids=[fn for _, fn in _SOURCE_FUNCTIONS])
def test_ctypes_signature_matches_the_c_parameters(lib, fn):
    # A wrong count or kind would pass garbage to the kernel on the card
    # (a pointer cut to 32 bits, arguments shifted by one).
    want = _extern_c_functions(CSRC / _kernels._SOURCES[lib])[fn]
    got = [_CTYPE_KINDS[t] for t in _kernels._SIGNATURES[lib][fn]]
    assert got == want


def test_parameter_parser_reads_each_kind():
    src = CSRC / "flash_bwd_tc.cu"
    kinds = _extern_c_functions(src)["mpi4torch_flash_bwd_tc_dq"]
    assert kinds == ["pointer"] * 7 + ["int"] * 6 + ["pointer"] \
        + ["int"] * 5 + ["pointer"]
    assert _extern_c_functions(CSRC / "quant_hop.cu")[
        "mpi4torch_quant_hop"][7] == "long long"
    fwd = _extern_c_functions(CSRC / "flash_fwd_tc.cu")
    assert fwd["mpi4torch_flash_fwd_tc"] == ["pointer"] * 5 + ["int"] * 6 \
        + ["pointer"] + ["int"] * 5 + ["pointer"]
    assert fwd["mpi4torch_flash_fwd_tc_props"] == ["int", "pointer"]
    simt = _extern_c_functions(CSRC / "flash_bwd.cu")
    assert simt["mpi4torch_flash_bwd_props"] == ["int"] * 3 + ["pointer"]


def test_a_failed_source_raises_after_every_compiler_ends(fake_toolkit):
    (fake_toolkit / "a.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match=r"nvcc failed to build .*a\.cu "
                                           r"\(exit 3\)"):
        _kernels._compile(["a", "b"])
    # The other source's compiler ran to its end and its library stands.
    assert _kernels.build_log["b"]["output"].startswith("ptxas info")
    assert "a" not in _kernels.build_log
