"""Build, binding and launch counts of the port's CUDA kernels.

The kernels live in `spann3r_torch/csrc/*.cu`, each behind a plain C entry
point. At the first CUDA use, one `nvcc` per source compiles them all at
once, and one more links the objects into a shared library under
`spann3r_torch/_build/`, named by a hash of the sources and flags so that
an edited source is rebuilt; `ctypes` loads it. Pointers and
the stream pass as `c_void_p`. Every entry point launches on the stream it
is given (PyTorch's current stream), allocates nothing, does not
synchronise, and returns `cudaGetLastError()`; `check` raises on a
non-zero code.

Each kernel wrapper adds one to its count in `LAUNCHES` when it launches
its kernel, and nowhere else, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

KERNELS = ("rope2d", "sdpa", "memory_read")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# dtype codes shared with the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
_f32 = ctypes.c_float

_SIGNATURES = {
    # n_ops, ptrs[3 n_ops], strides[9 n_ops], n_tokens[n_ops] (packed
    # uint64, int64 and int32 arrays), shared, dtype, B, H, D, vec, tile,
    # base, sign, stream
    "spann3r_rope2d": [_i32, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_char_p, _i32, _i32, _i32, _i32, _i32, _i32,
                       _i32, _f32, _f32, _vp],
    # q, k, v, out, dtype, B, H, N, M, D, 4 x (sb, sh, sn), scale, stream
    "spann3r_sdpa": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32]
                    + [_i64] * 12 + [_f32, _vp],
    # q, k, v, size, out, asum, workspace, dtype, B, P, C, D, scale,
    # attn_thresh, stream
    "spann3r_memory_read": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32,
                            _i32, _i32, _i32, _f32, _f32, _vp],
    # dtype, B, P, C, D -> workspace bytes
    "spann3r_memory_read_workspace": [_i32, _i32, _i32, _i32, _i32],
}
_RESTYPES = {"spann3r_memory_read_workspace": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspann3r_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the build directory unless the library for
    these sources exists already: the sources in parallel, then one link.
    Raises with nvcc's output on failure."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(str(obj))
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{out}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, *, dtype=None, device=None,
            shape=None, last_contiguous: bool = False,
            contiguous: bool = False) -> None:
    """Validate a kernel operand before its pointer is passed on."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if last_contiguous and t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride in its last dim")
    if t.dtype.is_floating_point and t.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {t.dtype} not supported by the "
                         f"kernels (float32, bfloat16)")
