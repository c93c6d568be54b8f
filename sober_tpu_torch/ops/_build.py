"""Build and load the hand-written CUDA kernels of `sober_tpu_torch/csrc`.

Each `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (`sm_90a`),
all of them at once, and the objects are linked into one shared library with
a plain C interface, loaded with `ctypes`. The build runs at the first
launch of any kernel, into `build/sober_tpu_torch/` at the root of the
checkout, and the library's name carries a hash of the sources and flags,
so unchanged sources are never rebuilt. Only the CUDA toolkit is needed;
nothing here imports PyTorch's C++ headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import timing

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sober_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the kernels' entry points: every pointer (and the stream)
# is a c_void_p, or ctypes would pass it as a 32-bit int
_SIGNATURES = {
    "sober_rbf_gram": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "sober_car_eliminate": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sober_pack_bits": (_P, _P, _P, _P, _I, _I, _P),
    "sober_tanimoto_gram": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME (default /usr/local/cuda): "
        "the CUDA kernels of sober_tpu_torch cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsober_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Raises RuntimeError with nvcc's output when nvcc is missing or fails.
    nvcc's report (registers, shared memory and spills per kernel, from
    `-Xptxas -v`) is kept beside the library with the suffix `.log`.
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        outs = [proc.communicate()[0] for proc in procs]
        steps = [(cmd, proc.returncode, out)
                 for cmd, proc, out in zip(compiles, procs, outs)]
        if all(rc == 0 for _, rc, _ in steps):
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.returncode, proc.stdout + proc.stderr))
        for cmd, rc, out in steps:
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed with exit code {rc}:\n"
                                   f"{' '.join(cmd)}\n{out}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(out for _, _, out in steps))
    os.replace(tmp, so)   # atomic: a concurrent build never loads a partial file
    return so


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. The first call's
    build or load is the recorder's `setup.library` span, kept whether the
    recorder is on or off."""
    global _lib
    if _lib is None:
        with timing.timed("setup.library", keep=True):
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sober_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.sober_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        what = load_library().sober_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch ({what})")
