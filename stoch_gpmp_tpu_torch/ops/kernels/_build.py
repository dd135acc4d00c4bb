"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file (and ``csrc/*.cpp``, host code) is compiled by its
own ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
all of them started together, on first use, and loaded with ``ctypes``. A
library's name carries a hash of its source, the headers and the flags, so
an edited source is rebuilt and a stale build is never loaded. The builds go to ``build/kernels/`` at the
repository root (git ignores ``build/``).

No ``--use_fast_math``: the kernels floor a division by the cell size and
must land in the same cell as the plain PyTorch version, so division,
``sqrtf``, ``logf``, ``expf`` and ``sincosf`` stay IEEE.
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
from types import SimpleNamespace

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


def _planar_step_args(rng):
    """The planar step launchers' arguments; ``rng`` is the random-source
    argument after eps (K2: a 64-bit seed, K9: per-particle seeds)."""
    return [
        _P, _P, _P, _P,  # means, W, lin_rows, A (or null)
        _P, _I, _P, _I,  # rect_bounds, R, circles, C
        _P, rng,  # eps (or null), seed or seeds
        _P, _P,  # new_means, costs
        _I, _I, _I, _I,  # P, S, M, n_dof
        _I, _I,  # use_stencil, CTAs per particle
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,  # dt, q11 q12 q22, ks.., kg..
        _P, _F, _F, _I, _I,  # PriorStencil*, cell_size, inv_cell_size, nx, ny
        _F, _F, _F,  # k_coll, temperature, step_size
        _P,  # stream
    ]


# C signatures of the entries; each returns an int, the launchers their cudaError_t
SIGNATURES = {
    "raster_field_launch": [
        _P, _I, _I, _I, _I, _I,  # points, B, L, stride_b, stride_l, stride_c (below 2^31)
        _P, _I, _P, _I,  # rect_bounds, R, circles, C
        _F, _F, _I, _I,  # cell_size, inv_cell_size, nx, ny
        _P, _P,  # out, stream
    ],
    "grid_lookup_launch": [
        _P, _I, _I,  # grid, nx, ny
        _P, _I, _I, _I, _I, _I,  # points, B, L, stride_b, stride_l, stride_c (below 2^31)
        _F, _P, _P,  # inv_cell_size, out, stream
    ],
    "primitive_field_launch": [
        _P, _I, _I, _I, _I, _I,  # points, B, L, stride_b, stride_l, stride_c (below 2^31)
        _P, _I, _P, _I,  # rects, R, circles, C
        _P, _P,  # out, stream
    ],
    "dof_quad_eval_launch": [
        _P, _P, _P, _P, _P,  # x, pu (or null), s_pd, g_pd, out
        _I, _I, _I, _I, _I,  # D, B, T, rows_per_goal, S
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,  # q11 q12 q22, ks.., kg.., dt
        _F, _P,  # temperature, stream
    ],
    "fk_fields_launch": [
        _P, _L, _L, _L, _I, _I,  # q, stride_dof, stride_b, stride_t, B, T
        _P, _I, _F, _F, _F,  # spheres, n_obst, inv_2m2, w_self, w_obst
        _P, _I, _P, _P,  # FkChain*, FK variant, out, stream
    ],
    "fk_fields_points_launch": [
        _P, _L, _L, _L,  # q, stride_n, stride_dof, N
        _P, _I, _F, _F, _F,  # spheres, n_obst, inv_2m2, w_self, w_obst
        _P, _I, _P, _P,  # FkChain*, FK variant, out, stream
    ],
    "link_fields_launch": [
        _P, _I, _I, _I, _I, _I, _I, _I,  # pos, N0, N1, strides (0, 1, link, coord), L
        _P, _I, _F, _F, _F,  # spheres, n_obst, inv_2m2, w_self, w_obst
        _P, _P,  # out, stream
    ],
    "fused_panda_step_launch": [
        _P, _P, _P, _P, _P,  # means, anchors, W, spheres, eps (or null)
        _P, _P, _I, _I,  # new_means, costs, CTAs per particle, FK variant
        _P, _P, _P,  # PandaStepParams*, FkChain*, stream
    ],
    # params, chain, CTAs, FK variant, int shape[4]
    "fused_panda_step_max_clusters": [_P, _P, _I, _I, _P],
    "fused_panda_dof_step_launch": [
        _P, _P, _P, _P, _P,  # means, g_pd, the backward tables, spheres, eps (or null)
        _P, _P, _I, _I,  # new_means, costs, CTAs, FK variant
        _P, _P, _P,  # DofStepParams*, FkChain*, stream
    ],
    # params, chain, FK variant, int shape[3]
    "fused_panda_dof_step_config": [_P, _P, _I, _P],
    "fk_chain_variant": [_P],  # FkChain* -> the FK walk (csrc/fk_spec.cpp; not an error code)
    "fused_planar_step_launch": _planar_step_args(ctypes.c_ulonglong),  # seed
    "fused_planar_step_per_particle_launch": _planar_step_args(_P),  # seeds [P, 2] or null
    "bidiag_scan_launch": [
        _P, _L, _L, _L,  # x, its strides (plane, batch, time) in elements
        _P, _L, _L, _L,  # y, its strides
        _P, _P, _P,  # rec, phr, psi tables of the direction
        _I, _I, _I, _I, _I,  # B, T, d, is_double, backward
        _I, _I, _P,  # the tables' steps per chunk and scan levels, stream
    ],  # 0: planes by TMA, -1: staged by the kernel's threads, else cudaError_t
    "bidiag_scan_launch_shaped": [
        _P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P,  # as bidiag_scan_launch
        _I, _I, _I, _I, _I, _I, _I,  # B, T, d, is_double, backward, steps per chunk, levels
        _P, _P,  # int shape[5] (rows, chunks, steps, buffers, stages), stream
    ],
    "bidiag_scan_config": [_I, _I, _I, _I, _P],  # B, T, d, is_double, int shape[7]
    "fused_planar_step_max_clusters": [
        _I, _I, _I, _I, _I,  # P, S, M, n_dof, CTAs per particle
        _I, _I, _I, _P,  # R, C, K9's instantiation, int shape[4]
    ],
    "block_chol_launch": [
        _P, _P, _P, _P, _P,  # diag, lower (or null), dout, lout (or null), linv (or null)
        _I, _I, _I, _I, _P,  # B, T, d, is_double, stream
    ],
}

_LIB = None
build_info: dict = {}  # per source: seconds, ptxas log, library path


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
    """Compile (once per source hash, one nvcc per source, in parallel) and
    load the kernel libraries; returns one namespace holding every
    launcher of ``SIGNATURES``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    headers = hashlib.sha256()
    for hdr in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        headers.update(hdr.name.encode())
        headers.update(hdr.read_bytes())
    headers.update(" ".join(NVCC_FLAGS).encode())
    out_dir = _PKG.parent / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")]):
        digest = headers.copy()
        digest.update(src.read_bytes())
        lib_path = out_dir / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
        build_info[src.name] = {"path": str(lib_path), "seconds": 0.0, "log": "(cached)"}
        if not lib_path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[src.name] = (proc, tmp, lib_path)
    failed = []
    for name, (proc, tmp, lib_path) in jobs.items():
        out, err = proc.communicate()
        build_info[name].update(seconds=time.perf_counter() - t0, log=err)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}\n{err}")
        else:
            os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    kernels = SimpleNamespace()
    for info in build_info.values():
        lib = ctypes.CDLL(info["path"])
        for name, argtypes in SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(kernels, name, fn)
        if hasattr(lib, "stoch_gpmp_error_string"):
            lib.stoch_gpmp_error_string.argtypes = [ctypes.c_int]
            lib.stoch_gpmp_error_string.restype = ctypes.c_char_p
            kernels.stoch_gpmp_error_string = lib.stoch_gpmp_error_string
    missing = [n for n in [*SIGNATURES, "stoch_gpmp_error_string"] if not hasattr(kernels, n)]
    if missing:
        raise RuntimeError(f"kernel libraries lack {missing}")
    _LIB = kernels
    return kernels


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        text = _LIB.stoch_gpmp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")


def stream_ptr(device) -> int:
    """The current stream of the CUDA ``device`` (a tensor's, with its
    index) as a ``cudaStream_t``: PyTorch's raw lookup, which builds no
    ``torch.cuda.Stream`` (``torch.cuda.current_stream(device).cuda_stream``
    took 4–6 µs a call on an H100 host)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


INDEX_LIMIT = 2**31


def check_index_range(name: str, t) -> None:
    """Raise unless ``t``'s element count and its largest element offset
    are below 2^31: the kernels that take strided points index in 32 bits."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    if t.numel() >= INDEX_LIMIT or last >= INDEX_LIMIT:
        raise ValueError(f"{name} indexes in 32 bits: {t.numel()} elements with offsets up to "
                         f"{last}, both must be below 2^31")
