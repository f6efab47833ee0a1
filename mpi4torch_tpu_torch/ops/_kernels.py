"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel source lives in ``ops/csrc/`` and is compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded through :mod:`ctypes`.  The library lands in the
package's ``build/`` directory (git-ignored) under a name that carries
the source's content hash, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import: the CPU test suite imports
every module on a machine without ``nvcc`` or a GPU.

Each launcher checks what its kernel takes and raises on anything else;
it never falls back to a plain version.  It adds one to its entry of
:data:`launch_counts` where it launches the kernel, and nowhere else, so
a run can prove that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SOURCES = {"flash_fwd": "flash_fwd.cu"}

_lock = threading.Lock()
_libs = {}
build_log = {}      # kernel name -> {"seconds": float, "output": str}
launch_counts = {name: 0 for name in _SOURCES}


def reset_launch_counts() -> None:
    with _lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit PyTorch itself located."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from ops/csrc at first use")


def _compile(name: str) -> str:
    src = os.path.join(_CSRC, _SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    lib = os.path.join(_BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(lib):
        build_log[name] = {"seconds": 0.0, "output": "cached"}
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    build_log[name] = {"seconds": seconds,
                       "output": (res.stdout + res.stderr).strip()}
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load kernel library ``name``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_compile(name))
            if name == "flash_fwd":
                fn = lib.mpi4torch_flash_fwd
                fn.argtypes = ([ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 7
                               + [ctypes.c_void_p]
                               + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def build_all() -> dict:
    """Build every kernel library; returns :data:`build_log`."""
    for name in _SOURCES:
        load(name)
    return dict(build_log)


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd(q, k, v, q_off: int, kv_off: int, causal: bool,
              window: int = 0):
    """Launch the CUDA block-attention forward (``csrc/flash_fwd.cu``).

    ``q`` is ``(b, sq, h, d)``, ``k``/``v`` ``(b, sk, h_kv, d)``, all on
    one CUDA device, float32 or bfloat16, last dimension contiguous;
    ``d`` a multiple of 8 up to 256; ``h`` a multiple of ``h_kv``;
    offsets are scalar ints.  Returns ``(out, lse)``: ``out`` like ``q``
    (contiguous), ``lse`` float32 ``(b, sq, h)``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_fwd: {name} must be a CUDA tensor, "
                             f"got device {t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd: {name} must be 4-d, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _FLASH_DTYPES or t.dtype != q.dtype:
            raise ValueError(
                f"flash_fwd: q/k/v must share one dtype of float32 or "
                f"bfloat16; got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.device != q.device:
            raise ValueError("flash_fwd: q, k and v must be on one device")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_fwd: {name}'s last dimension must be "
                             "contiguous")
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_fwd: q{tuple(q.shape)} and "
                         f"k{tuple(k.shape)}/v{tuple(v.shape)} must agree "
                         "on batch and head_dim, and k/v must match")
    if h_kv < 1 or h % h_kv != 0:
        raise ValueError(f"flash_fwd: query heads ({h}) must be a multiple "
                         f"of KV heads ({h_kv})")
    if d % 8 != 0 or not 8 <= d <= 256:
        raise ValueError(f"flash_fwd: head_dim must be a multiple of 8 in "
                         f"[8, 256], got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_fwd: batch x heads = {b * h} exceeds the "
                         "grid limit 65535")
    if window < 0 or (window and not causal):
        raise ValueError("flash_fwd: window must be >= 0 and needs causal")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return out, lse
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    fn = load("flash_fwd").mpi4torch_flash_fwd
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _FLASH_DTYPES[q.dtype], b, h, h_kv, sq, sk,
                 d, strides, int(q_off), int(kv_off), int(bool(causal)),
                 int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with CUDA error "
                           f"{err}")
    _count("flash_fwd")
    return out, lse
