"""Builds the port's CUDA kernels and counts their launches.

Each source under ``cake_tpu_torch/csrc/`` is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens at first use, into
``cake_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries the hash of the source, of the ``csrc/`` headers it includes and
of the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. :func:`build_all` starts
one ``nvcc`` per missing library, all at once.

No PyTorch header is compiled: a source that includes them takes minutes
to build, a plain C one seconds.

Each kernel has one launch counter. A wrapper adds one where it launches
its kernel and nowhere else, so a run can show that its path went through
the kernels (:func:`launches`, :func:`reset_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> source file under csrc/
SOURCES = {
    "flash_prefill": "flash_prefill.cu",
    "flash_decode": "flash_decode.cu",
    "flash_prefill_q8": "flash_prefill_q8.cu",
    "flash_decode_q8": "flash_decode_q8.cu",
    "quant_matmul": "quant_matmul.cu",
    "quant4_matmul": "quant4_matmul.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LAUNCHES = {name: 0 for name in SOURCES}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every file under ``csrc/`` it includes with quotes,
    transitively, each with its bytes."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _LOCAL_INCLUDE.findall(seen[path]):
            dep = path.parent / inc.decode()
            if dep.exists():
                _sources(dep, seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(CSRC / SOURCES[name], {}).values():
        h.update(src)
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when ``name`` was built (registers,
    shared memory and spills of each kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=None) -> list[str]:
    """Build every missing library, one ``nvcc`` each, all started together;
    returns the names that were built. Raises with nvcc's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in (names or SOURCES) if not library_path(n).exists()]
    if not todo:
        return []
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        # per-process temp name, renamed into place: concurrent builders
        # never load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = library_path(name)
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def entry(name: str, argtypes, consts: dict[str, int]):
    """``(lib, fn)``: the library of kernel ``name`` and its C entry
    ``{name}_bf16`` with ``argtypes`` set. Each ``consts`` item is a tile
    size the wrapper computes with; the library's ``{name}_{key}()`` must
    return the same value, or this raises."""
    lib = library(name)
    for key, want in consts.items():
        fn = getattr(lib, f"{name}_{key}")
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}: the library's {key} {fn()} differs "
                               f"from the wrapper's {want}")
    fn = getattr(lib, f"{name}_bf16")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib, fn


def check(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({fn(err).decode()})")
