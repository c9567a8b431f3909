"""Builds the port's CUDA kernels and counts their launches.

Each source under ``cake_tpu_torch/csrc/`` is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens at first use, into
``cake_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries the hash of the source, of the ``csrc/`` headers it includes and
of the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. :func:`build_all` starts
one ``nvcc`` per missing library, all at once, under an exclusive lock on
``_build/.build.lock`` (``flock``): processes that ask for the same build
at once (a mesh's ranks) get one build, and the others load its result.
The kernel drops the lock when its holder dies, so a run cut off mid-build
leaves nothing to clean up.

No PyTorch header is compiled: a source that includes them takes minutes
to build, a plain C one seconds.

Each kernel has one launch counter. A wrapper adds one where it launches
its kernel and nowhere else, so a run can show that its path went through
the kernels (:func:`launches`, :func:`reset_launches`); a CUDA graph's
replay adds the launches its capture recorded (:func:`add_launches`).

:func:`build_shim` builds the embedding shim ``native/cake_embed.cc`` the
same way, with ``g++`` and Python's include and link flags (from
``sysconfig``: a machine may have no ``python3-config``).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import torch

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
    # the statistics forms of the flash kernels (ring attention and the
    # sequence-sharded decode): the same headers, another epilogue
    "flash_prefill_stats": "flash_prefill_stats.cu",
    "flash_decode_stats": "flash_decode_stats.cu",
    "flash_decode_q8_stats": "flash_decode_q8_stats.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LAUNCHES = {name: 0 for name in SOURCES}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# .counts, .launched: a recording of this thread's launches (recording())
_REC = threading.local()


def count_launch(name: str) -> None:
    counts = getattr(_REC, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
        if not _REC.launched:
            return
    _LAUNCHES[name] += 1


@contextlib.contextmanager
def recording(launched: bool = True):
    """Yields a dict of the launches this thread's wrappers count inside
    the block (another thread's launches stay out of it). ``launched``
    False: a CUDA graph's capture (``runtime/graphs.py``), whose wrappers
    count launches that it records and does not make: they go into the
    dict only, and each replay adds them (:func:`add_launches`)."""
    counts: dict[str, int] = {}
    _REC.counts, _REC.launched = counts, launched
    try:
        yield counts
    finally:
        _REC.counts = None


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` at once: a CUDA graph's replay launches the kernels
    its capture recorded."""
    for name, n in counts.items():
        _LAUNCHES[name] += n


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def refuse_growth_in_capture(device, what: str) -> None:
    """Raise where a module cache (``what``) would grow on ``device``
    inside a CUDA graph capture: the new tensor would come from the
    graph's private pool and outlive it in the cache. A capture's warm-up
    run (``runtime/graphs.py``) sizes every cache first."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} must be sized before a CUDA graph "
                           "capture (run the body once first)")


# a launch's work split is a function of its shapes; the interleaved
# schedules run a 1/factor share of a batch's rows in each call, and pin
# the split to the whole batch's so the rows get the serialized call's
# bits (the quantized matmuls' regime, the decodes' KV splits)
_PIN = threading.local()


@contextlib.contextmanager
def pinned_rows(factor: int):
    """Within the block, the matmul plans and decode splits are those of
    ``factor`` times the rows of each call."""
    prev = rows_factor()
    _PIN.factor = factor
    try:
        yield
    finally:
        _PIN.factor = prev


def rows_factor() -> int:
    return getattr(_PIN, "factor", 1)


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


@contextlib.contextmanager
def build_lock():
    """The build directory's lock, held across processes while a build
    runs (``flock`` on ``.build.lock``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=None) -> list[str]:
    """Build every missing library, one ``nvcc`` each, all started together;
    returns the names that were built (by this process: a library another
    process built while this one waited for the lock is loaded, not
    rebuilt). Raises with nvcc's output if one fails."""
    with build_lock():
        return _build_missing(names)


def _build_missing(names) -> list[str]:
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


SHIM_SRC = _PKG / "native" / "cake_embed.cc"


def shim_flags() -> list[str]:
    """``g++`` flags of the embedding shim: Python's headers, and its
    shared library where the interpreter has one (a statically linked
    interpreter exports the symbols the shim then resolves at load)."""
    flags = ["-O2", "-fPIC", "-shared",
             f"-I{sysconfig.get_config_var('INCLUDEPY')}"]
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        libdir = sysconfig.get_config_var("LIBDIR")
        lib = sysconfig.get_config_var("LDLIBRARY")  # libpython3.X.so
        flags += [f"-L{libdir}", f"-l{lib[3:].split('.so')[0]}",
                  f"-Wl,-rpath,{libdir}"]
    return flags


def shim_path() -> Path:
    h = hashlib.sha256(SHIM_SRC.read_bytes())
    h.update(" ".join(shim_flags()).encode())
    return BUILD_DIR / f"libcakeembed-{h.hexdigest()[:16]}.so"


def build_shim() -> Path:
    """The embedding shim's library, built first if missing; raises with
    ``g++``'s output if the build fails."""
    out = shim_path()
    with _LOCK, build_lock():
        if out.exists():
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        r = subprocess.run(["g++", *shim_flags(), "-o", str(tmp),
                            str(SHIM_SRC)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"embedding shim build failed (g++ exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out
