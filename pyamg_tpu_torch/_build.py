"""Build the hand-written CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all of them
started together, and the objects are linked into ONE shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <work>/<source>.o csrc/<source>.cu   # each
    nvcc -shared -o _build/libpyamg_tpu_torch_<hash>.so <work>/*.o

The library lands in ``pyamg_tpu_torch/_build/`` (git-ignored), named by
a hash of the sources and flags, so an unchanged tree builds once.  The
build runs at the first kernel launch on a CUDA tensor, never at import
and never for a CPU tensor.  Pointers and the stream pass as
``c_void_p``; each C entry point returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

``launches`` counts kernel launches per ``"<kernel>.<dtype>"``: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["library", "build", "check", "launches", "reset_launches",
           "count_launch", "on_cpu", "check_vector", "check_stack",
           "dtype_name", "lane_chunks",
           "NVCC_FLAGS", "MAX_LANES"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_LINK_FLAGS = ("-shared",)
# -Xptxas -v prints registers, shared memory and spills per kernel into
# the build log; it changes nothing in the generated code.
_REPORT_FLAGS = ("-Xptxas", "-v")

launches: dict[str, int] = {}

# lanes per launch of every K-lane kernel: each holds its lanes' sums in a
# register array of this size (kMaxLanes in csrc/*.cu)
MAX_LANES = 16

_lock = threading.Lock()
_lib = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes; every function returns the cudaError_t as int
_SIGNATURES = {
    # data, offsets, nd, n_pad, x, b, dinv, omega, omega_dev, y, r, mode,
    # stream
    "pyamg_dia_f32": (_P, _P, _I, _L, _P, _P, _P, ctypes.c_float, _P, _P, _P,
                      _I, _P),
    "pyamg_dia_f64": (_P, _P, _I, _L, _P, _P, _P, ctypes.c_double, _P, _P,
                      _P, _I, _P),
    # data, offsets, nd, sdata, soffsets, nds, n_pad, x, b, dinv, tv, omega,
    # omega_dev, out0, out1, mode, stream
    "pyamg_dia_chain_f32": (_P, _P, _I, _P, _P, _I, _L, _P, _P, _P, _P,
                            ctypes.c_float, _P, _P, _P, _I, _P),
    "pyamg_dia_chain_f64": (_P, _P, _I, _P, _P, _I, _L, _P, _P, _P, _P,
                            ctypes.c_double, _P, _P, _P, _I, _P),
    # data, offsets, nd, n_pad, lanes, x, b, dinv, omega, omega_dev, y, r,
    # mode, stream
    "pyamg_dia_k_f32": (_P, _P, _I, _L, _I, _P, _P, _P, ctypes.c_float, _P,
                        _P, _P, _I, _P),
    "pyamg_dia_k_f64": (_P, _P, _I, _L, _I, _P, _P, _P, ctypes.c_double,
                        _P, _P, _P, _I, _P),
    # data, offsets, nd, sdata, soffsets, nds, n_pad, lanes, b, dinv, tv,
    # omega, omega_dev, x_out, y_out, stream
    "pyamg_dia_zero_chain_k_f32": (_P, _P, _I, _P, _P, _I, _L, _I, _P, _P,
                                   _P, ctypes.c_float, _P, _P, _P, _P),
    "pyamg_dia_zero_chain_k_f64": (_P, _P, _I, _P, _P, _I, _L, _I, _P, _P,
                                   _P, ctypes.c_double, _P, _P, _P, _P),
    # data, idx, starts, k, block, w2, n_rows, x, y, stream
    "pyamg_windowed_matvec_f32": (_P, _P, _P, _I, _I, _I, _L, _P, _P, _P),
    "pyamg_windowed_matvec_f64": (_P, _P, _P, _I, _I, _I, _L, _P, _P, _P),
    # data, perm, colptr, k, block, m, r, y, stream
    "pyamg_windowed_rmatvec_f32": (_P, _P, _P, _I, _I, _L, _P, _P, _P),
    "pyamg_windowed_rmatvec_f64": (_P, _P, _P, _I, _I, _L, _P, _P, _P),
    # data, idx, starts, k, block, w2, n_rows, m, lanes, x, y, stream
    "pyamg_windowed_matmat_k_f32": (_P, _P, _P, _I, _I, _I, _L, _L, _I, _P,
                                    _P, _P),
    "pyamg_windowed_matmat_k_f64": (_P, _P, _P, _I, _I, _I, _L, _L, _I, _P,
                                    _P, _P),
    # data, perm, colptr, k, block, n_rows, m, lanes, r, y, stream
    "pyamg_windowed_rmatmat_k_f32": (_P, _P, _P, _I, _I, _L, _L, _I, _P, _P,
                                     _P),
    "pyamg_windowed_rmatmat_k_f64": (_P, _P, _P, _I, _I, _L, _L, _I, _P, _P,
                                     _P),
    # idx, starts, k, block, w2, n_rows, x, out, stream
    "pyamg_windowed_select_f32": (_P, _P, _I, _I, _I, _L, _P, _P, _P),
    "pyamg_windowed_select_f64": (_P, _P, _I, _I, _I, _L, _P, _P, _P),
    # data, offsets, nd, n_pad, K, k0, lanes, in, aux, vec, out0, out1,
    # mode, stream
    "pyamg_interleaved_f32": (_P, _P, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P,
                              _I, _P),
    # data, ld, offsets, nd, n_local, halo, left, x, right, a0, a1, b0, b1,
    # y, stream
    "pyamg_halo_spmv_f32": (_P, _L, _P, _I, _L, _I, _P, _P, _P, _L, _L, _L,
                            _L, _P, _P),
    "pyamg_halo_spmv_f64": (_P, _L, _P, _I, _L, _I, _P, _P, _P, _L, _L, _L,
                            _L, _P, _P),
}


# -- helpers of the kernel wrappers ------------------------------------------

def on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU (the plain twin's case);
    False when all lie on one CUDA device; raises on a mix or another
    device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check_vector(name, v, n, dtype):
    """Raise unless ``v`` is a contiguous 1-D ``dtype`` vector of length n."""
    if v.ndim != 1 or v.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got "
                         f"{tuple(v.shape)}")
    if v.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_stack(name, v, n, dtype, lanes=None):
    """Raise unless ``v`` is a contiguous K-major ``dtype`` lane stack of
    shape (K, n) (with K == ``lanes`` when given)."""
    if v.ndim != 2 or v.shape[1] != n or (lanes is not None
                                          and v.shape[0] != lanes):
        want = f"({'K' if lanes is None else lanes}, {n})"
        raise ValueError(f"{name}: expected shape {want}, got "
                         f"{tuple(v.shape)}")
    if v.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def lane_chunks(K):
    """(k0, k1) lane ranges of at most MAX_LANES lanes, one launch each."""
    return [(k0, min(K, k0 + MAX_LANES)) for k0 in range(0, K, MAX_LANES)]


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def reset_launches():
    launches.clear()


def count_launch(name: str):
    launches[name] = launches.get(name, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels of pyamg_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True)


def _failed(cmd, proc):
    return RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Compile csrc/ into the cached shared library; returns its path."""
    sources, headers = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _LINK_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libpyamg_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects = [work / f"{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, *_REPORT_FLAGS, "-I", str(CSRC), "-c",
             "-o", str(obj), str(src)] for src, obj in zip(sources, objects)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        procs = list(pool.map(_run, cmds))
    for cmd, proc in zip(cmds, procs):
        if proc.returncode != 0:
            raise _failed(cmd, proc)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc, *NVCC_FLAGS, *_LINK_FLAGS, "-o", str(tmp),
            *map(str, objects)]
    proc = _run(link)
    if proc.returncode != 0:
        raise _failed(link, proc)
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False,
                      log="".join(p.stdout + p.stderr for p in procs))
    return out


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.pyamg_error_string.argtypes = [ctypes.c_int]
    lib.pyamg_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(build())
        return _lib


def check(name: str, err: int):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().pyamg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
