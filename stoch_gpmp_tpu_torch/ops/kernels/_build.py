"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, on first use, and loaded with
``ctypes``. The library's name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale build is never loaded. The build
goes to ``build/kernels/`` at the repository root (git ignores ``build/``).

No ``--use_fast_math``: the kernels floor a division by the cell size and
must land in the same cell as the plain PyTorch version, so division,
``sqrtf``, ``logf`` and ``sincosf`` stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the launchers; each returns its cudaError_t as an int
SIGNATURES = {
    "raster_field_launch": [
        _P, _L, _L, _L, _L, _L,  # points, B, L, stride_b, stride_l, stride_c
        _P, _I, _P, _I,  # rect_bounds, R, circles, C
        _F, _F, _I, _I,  # cell_size, inv_cell_size, nx, ny
        _P, _P,  # out, stream
    ],
    "fused_planar_step_launch": [
        _P, _P, _P, _P, _P,  # means, prec_u, W, lin_rows, A (or null)
        _P, _I, _P, _I,  # rect_bounds, R, circles, C
        _P, ctypes.c_ulonglong,  # eps (or null), seed
        _P, _P, _P,  # new_means, costs, x scratch
        _I, _I, _I, _I,  # P, S, M, n_dof
        _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,  # use_stencil, dt, q11 q12 q22, ks.., kg..
        _F, _F, _I, _I,  # cell_size, inv_cell_size, nx, ny
        _F, _F, _F,  # k_coll, temperature, step_size
        _P,  # stream
    ],
}

_LIB = None
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library():
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = _PKG.parent / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libstoch_gpmp_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        build_info.update(seconds=time.perf_counter() - t0, log=proc.stderr)
    else:
        build_info.update(seconds=0.0, log="(cached)")
    build_info["path"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.stoch_gpmp_error_string.argtypes = [ctypes.c_int]
    lib.stoch_gpmp_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        text = _LIB.stoch_gpmp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
