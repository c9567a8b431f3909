"""The kernel build is keyed by everything a source compiles: an edit to a
shared ``csrc/`` header must rebuild each kernel that includes it, and only
those. Needs no ``nvcc``: only the library paths are computed."""

import shutil

import pytest

from cake_tpu_torch.ops.kernels import build

FLASH = {"flash_prefill", "flash_prefill_q8", "flash_prefill_stats"}
DECODE = {"flash_decode", "flash_decode_q8", "flash_decode_stats",
          "flash_decode_q8_stats"}
MATMUL = {"quant_matmul", "quant4_matmul"}


def _paths():
    return {name: build.library_path(name) for name in build.SOURCES}


def _includers(header):
    """The kernels whose sources include ``header``, directly or through
    another header."""
    return {name for name, src in build.SOURCES.items()
            if build.CSRC / header in build._sources(build.CSRC / src, {})}


@pytest.mark.parametrize("header,includers", [
    ("flash_prefill_sm90.cuh", FLASH),
    ("flash_decode_sm90.cuh", DECODE),
    ("qmatmul_sm90.cuh", MATMUL),
    ("sm90.cuh", FLASH | DECODE | MATMUL),
])
def test_header_edit_changes_the_including_kernels_paths(tmp_path,
                                                         monkeypatch,
                                                         header, includers):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    assert _includers(header) == includers
    before = _paths()
    assert all(p.parent == tmp_path / "_build" for p in before.values())
    with open(csrc / header, "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    for name in build.SOURCES:
        if name in includers:
            assert after[name] != before[name], name
        else:
            assert after[name] == before[name], name
    # and a source edit changes only its own kernel's path
    with open(csrc / build.SOURCES["flash_decode"], "a") as f:
        f.write("\n// an edit\n")
    again = _paths()
    assert {n for n in again if again[n] != after[n]} == {"flash_decode"}


def test_kernel_without_includes_keeps_its_source_and_flags_hash(
        tmp_path, monkeypatch):
    """A source that includes no header hashes as the source and the flags
    alone, so its library survives a header-only change elsewhere. (Every
    kernel of the package includes a header, so the source is made here.)"""
    import hashlib

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    name = "plain_kernel"
    src = b"#include <cuda_runtime.h>\nextern \"C\" int plain() { return 0; }\n"
    (csrc / "plain_kernel.cu").write_bytes(src)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setitem(build.SOURCES, name, "plain_kernel.cu")
    assert b'#include "' not in src
    digest = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode())
    before = build.library_path(name)
    assert before.name == f"{name}-{digest.hexdigest()[:16]}.so"
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("\n// an edit\n")
    assert build.library_path(name) == before


FAKE_NVCC = """#!/bin/sh
# records its call, takes a while, and writes the library it was asked for
echo "$$" >> "{log}"
sleep 1
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
"""

BUILD_ONE = ("import sys\n"
             "from pathlib import Path\n"
             "from cake_tpu_torch.ops.kernels import build\n"
             "build.BUILD_DIR = Path(sys.argv[1])\n"
             "print(build.build_all(['flash_decode']))\n")


def test_concurrent_builds_of_one_kernel_build_it_once(tmp_path):
    """Two processes asking for the same kernel at once (a mesh's ranks)
    get one build: the second waits on the build lock and then finds the
    library."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(repo))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE,
                               str(tmp_path / "_build")], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = sorted(p.communicate(timeout=60)[0].strip() for p in procs)
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == ["['flash_decode']", "[]"]
    assert len(log.read_text().split()) == 1
    built = list((tmp_path / "_build").glob("flash_decode-*.so"))
    assert len(built) == 1 and built[0].read_text() == "built\n"
