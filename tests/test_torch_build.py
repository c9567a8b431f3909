"""The kernel build is keyed by everything a source compiles: an edit to a
shared ``csrc/`` header must rebuild each kernel that includes it, and only
those. Needs no ``nvcc``: only the library paths are computed."""

import shutil

import pytest

from cake_tpu_torch.ops.kernels import build

FLASH = {"flash_prefill", "flash_prefill_q8"}
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
    ("qmatmul_sm90.cuh", MATMUL),
    ("sm90.cuh", FLASH | MATMUL),
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


def test_kernel_without_includes_keeps_its_source_and_flags_hash():
    """A source that includes no header hashes as the source and the flags
    alone, so its library survives a header-only change elsewhere."""
    import hashlib

    name = "flash_decode"
    src = (build.CSRC / build.SOURCES[name]).read_bytes()
    assert b'#include "' not in src
    digest = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode())
    assert build.library_path(name).name == (
        f"{name}-{digest.hexdigest()[:16]}.so")
