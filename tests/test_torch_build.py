"""The kernel build is keyed by everything a source compiles: an edit to a
shared ``csrc/`` header must rebuild each kernel that includes it, and only
those. Needs no ``nvcc``: only the library paths are computed."""

import shutil

from cake_tpu_torch.ops.kernels import build

HEADER = "flash_prefill_sm90.cuh"


def _paths():
    return {name: build.library_path(name) for name in build.SOURCES}


def _includers():
    return {name for name, src in build.SOURCES.items()
            if f'#include "{HEADER}"' in (build.CSRC / src).read_text()}


def test_header_edit_changes_the_including_kernels_paths(tmp_path,
                                                         monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    includers = _includers()
    assert includers == {"flash_prefill", "flash_prefill_q8"}
    before = _paths()
    assert all(p.parent == tmp_path / "_build" for p in before.values())
    with open(csrc / HEADER, "a") as f:
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

    name = "quant_matmul"
    src = (build.CSRC / build.SOURCES[name]).read_bytes()
    assert b'#include "' not in src
    digest = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode())
    assert build.library_path(name).name == (
        f"{name}-{digest.hexdigest()[:16]}.so")
