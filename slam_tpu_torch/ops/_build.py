"""Build and bind the CUDA kernels of ``slam_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` to an object file, one process per
source, all started together, and links them into one shared library with
a plain C interface, loaded with ``ctypes``; each entry point is resolved
once per (kernel, dtype) when the library loads.  The library lands in
``slam_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F64 = ctypes.c_double
_INT = ctypes.c_int
_SIGNATURES = {
    "slam_gather_rows": [_P, _P, _P, _I64, _I64, _P],
    "slam_scatter_add_rows": [_P, ctypes.c_int32, _P, _I64, _P],
    "slam_linearize_se2": [_P] * 7 + [_F64, _F64, _INT, _P, _I64, _P],
    "slam_linearize_se2_indexed": [_P] * 6 + [_F64, _F64, _INT, _P, _I64,
                                              _P],
    "slam_micro_chol_inv": [_P, _P, _P, _I64, _I64] + [_INT] * 5 + [_P],
    "slam_stack_cholesky": [_P, _I64, _I64, _P, _P, _P, _I64, _I64, _INT,
                            _INT, _P, _P],
}

_lib: ctypes.CDLL | None = None
#: ``(entry point name, torch dtype) -> ctypes function``, filled by lib().
_entries: dict = {}
_raw_stream = None  # device index -> raw handle of its current stream
#: What the last build did: ``{"path", "seconds", "built", "log"}``.
build_info: dict = {}


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    t0 = time.perf_counter()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, built=False, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for name, _, proc in procs:
            text, _ = proc.communicate(timeout=900)
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True, timeout=900)
    finally:
        for _, obj, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      built=True, log="\n".join(log))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, _raw_stream
    if _lib is None:
        import torch

        handle = ctypes.CDLL(str(build()))
        for base, argtypes in _SIGNATURES.items():
            for dtype, suffix in ((torch.float32, "_f32"),
                                  (torch.float64, "_f64")):
                fn = getattr(handle, base + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[base, dtype] = fn
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _lib = handle
    return _lib


def entry(base: str, dtype):
    """The C entry point ``base`` for ``dtype`` (float32 or float64)."""
    fn = _entries.get((base, dtype))
    if fn is None:
        if _lib is None:
            lib()
            return entry(base, dtype)
        raise TypeError(f"kernels take float32 or float64, not {dtype}")
    return fn


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(index: int) -> int:
    """Raw handle of the current stream of CUDA device ``index``, read anew
    on every call (so a launch follows a stream switch or a graph
    capture)."""
    if _raw_stream is None:
        lib()
    return _raw_stream(index)
