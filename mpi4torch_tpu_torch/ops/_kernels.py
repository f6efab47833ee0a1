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

Kernels and the sources that hold them:

* ``flash_fwd`` — block attention forward, and ``flash_bwd_dq``,
  ``flash_bwd_dkv`` — its backward (dq; dk and dv).  Each comes in two
  variants that :func:`fwd_variant` (alias :func:`bwd_variant`) picks
  from the dtype and head dim: ``"tc"`` (``csrc/flash_fwd_tc.cu``,
  ``csrc/flash_bwd_tc.cu``: bf16 on the tensor cores, d <= 128) and
  ``"simt"`` (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``: f32 FMA on
  the CUDA cores; float32, float16 cast to float32, and bf16 with d >
  128, up to d = 512).  A head dim that is not a multiple of 8 runs
  zero-padded to the next one.  Each launch counts under the kernel's
  name and under ``"<name>.<variant>"``;
* ``q8_hop``, ``q8_requant`` — ``csrc/quant_hop.cu``, one quantized ring
  hop: ``q8_hop`` counts launches with an arriving payload, ``q8_requant``
  those of hop 0 and the codec encode (no payload yet).
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
# Library name -> source file.
_SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_fwd_tc": "flash_fwd_tc.cu",
            "flash_bwd": "flash_bwd.cu", "flash_bwd_tc": "flash_bwd_tc.cu",
            "quant_hop": "quant_hop.cu"}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Library name -> {exported C function: argument types}.
_SIGNATURES = {
    "flash_fwd": {"mpi4torch_flash_fwd":
                  [_P] * 5 + [_I] * 7 + [_P] + [_I] * 5 + [_P],
                  "mpi4torch_flash_fwd_props": [_I, _I, _P]},
    "flash_fwd_tc": {"mpi4torch_flash_fwd_tc":
                     [_P] * 5 + [_I] * 6 + [_P] + [_I] * 5 + [_P],
                     "mpi4torch_flash_fwd_tc_props": [_I, _P]},
    "flash_bwd": {"mpi4torch_flash_bwd_dq":
                  [_P] * 7 + [_I] * 7 + [_P] + [_I] * 5 + [_P],
                  "mpi4torch_flash_bwd_dkv":
                  [_P] * 8 + [_I] * 7 + [_P] + [_I] * 5 + [_P],
                  "mpi4torch_flash_bwd_props": [_I, _I, _I, _P]},
    "flash_bwd_tc": {"mpi4torch_flash_bwd_tc_dq":
                     [_P] * 7 + [_I] * 6 + [_P] + [_I] * 5 + [_P],
                     "mpi4torch_flash_bwd_tc_dkv":
                     [_P] * 8 + [_I] * 6 + [_P] + [_I] * 5 + [_P],
                     "mpi4torch_flash_bwd_tc_props": [_I, _I, _P]},
    "quant_hop": {"mpi4torch_quant_hop": [_P] * 7 + [_L, _I, _I, _P]},
}

_lock = threading.Lock()
_libs = {}
build_log = {}      # library name -> {"seconds": float, "output": str}
VARIANTS = ("tc", "simt")
ATTENTION_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
launch_counts = {**{name: 0 for name in ATTENTION_KERNELS},
                 **{f"{name}.{variant}": 0 for name in ATTENTION_KERNELS
                    for variant in VARIANTS},
                 "q8_hop": 0, "q8_requant": 0}


def reset_launch_counts() -> None:
    with _lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(*names: str) -> None:
    with _lock:
        for name in names:
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


def _compile(names) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together; returns name -> path of
    its shared library."""
    paths, procs = {}, {}
    for name in names:
        src = os.path.join(_CSRC, _SOURCES[name])
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        paths[name] = os.path.join(_BUILD_DIR, f"lib{name}_{digest}.so")
        if os.path.exists(paths[name]):
            build_log[name] = {"seconds": 0.0, "output": "cached"}
            continue
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, src, time.perf_counter())
    failed = []
    for name, (proc, tmp, src, t0) in procs.items():
        output = proc.communicate()[0].strip()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src} (exit "
                          f"{proc.returncode}):\n{output}")
            continue
        os.replace(tmp, paths[name])
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "output": output}
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load_locked(names) -> None:
    missing = [name for name in names if name not in _libs]
    for name, path in _compile(missing).items():
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load kernel library ``name``."""
    with _lock:
        _load_locked([name])
        return _libs[name]


def build_all() -> dict:
    """Build every kernel library, one ``nvcc`` per source, all started
    together; returns :data:`build_log`."""
    with _lock:
        _load_locked(list(_SOURCES))
    return dict(build_log)


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Operand dtypes the attention launchers take: the kernels' own, and
# float16, which runs the simt kernel in float32 (cast in, cast out).
_ATTENTION_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The widest head dim the kernels take (simt, DMAX 512).
MAX_HEAD_DIM = 512


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run at: ``d`` rounded up to a multiple of
    8 (the launchers zero-pad the operands; zero columns change no dot
    product, and the softmax scale stays ``1 / sqrt(d)``)."""
    return -(-int(d) // 8) * 8


def _check_attention(fn: str, q, k, v, causal: bool, window: int,
                     more=()) -> None:
    """What every flash launcher takes: q ``(b, sq, h, d)`` and k/v
    ``(b, sk, h_kv, d)`` on one CUDA device, in one dtype, last dimension
    contiguous, ``1 <= d <= 512``, ``h`` a multiple of ``h_kv``.  ``more``
    holds further ``(name, tensor)`` operands shaped and typed like q.

    Dtypes: float32 and bfloat16 run in their own type; float16 runs the
    simt kernel in float32 (the launcher casts the operands in and the
    results out, ``lse`` stays float32), as the JAX package computes
    attention in at least float32.  float64 raises a ``ValueError`` naming
    the dtype: no kernel of the JAX package takes it, and a float64 kernel
    is not on ROADMAP.md's queues; the plain version (``impl="torch"``)
    serves it.  A head dim that is not a multiple of 8 is zero-padded to
    the next one (:func:`padded_head_dim`)."""
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(more):
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor, "
                             f"got device {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{fn}: {name} must be 4-d, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _ATTENTION_DTYPES or t.dtype != q.dtype:
            raise ValueError(
                f"{fn}: q/k/v must share one dtype of float32, bfloat16 or "
                f"float16; got {name} {t.dtype} with q {q.dtype} (no CUDA "
                "attention kernel takes float64 or other dtypes, and none is "
                "queued in ROADMAP.md; use impl='torch')")
        if t.device != q.device:
            raise ValueError(f"{fn}: every operand must be on one device")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name}'s last dimension must be "
                             "contiguous")
    for name, t in more:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{fn}: {name}{tuple(t.shape)} must be "
                             f"shaped like q{tuple(q.shape)}")
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{fn}: q{tuple(q.shape)} and "
                         f"k{tuple(k.shape)}/v{tuple(v.shape)} must agree "
                         "on batch and head_dim, and k/v must match")
    if h_kv < 1 or h % h_kv != 0:
        raise ValueError(f"{fn}: query heads ({h}) must be a multiple "
                         f"of KV heads ({h_kv})")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head_dim must be in [1, {MAX_HEAD_DIM}], "
                         f"got {d}")
    if window < 0 or (window and not causal):
        raise ValueError(f"{fn}: window must be >= 0 and needs causal")


def _kernel_operands(ts):
    """The operands as the kernels take them: float16 cast to float32, and
    a head dim that is not a multiple of 8 zero-padded to the next one.
    Tensors that need neither come back as they are."""
    out = []
    for t in ts:
        if t.dtype == torch.float16:
            t = t.float()
        pad = padded_head_dim(t.shape[-1]) - t.shape[-1]
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        out.append(t)
    return out


def _caller_result(t, d: int, dtype):
    """A kernel output back in the caller's head dim and dtype
    (contiguous)."""
    if t.shape[-1] != d:
        t = t[..., :d].contiguous()
    return t if t.dtype == dtype else t.to(dtype)


def _check_row_stats(fn: str, q, stats) -> None:
    """Row statistics (lse, dd): float32 ``(b, sq, h)`` on q's device."""
    for name, t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:3]) \
                or t.device != q.device:
            raise ValueError(
                f"{fn}: {name} must be float32 {tuple(q.shape[:3])} on "
                f"{q.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _strides(*tensors):
    """The (batch, seq, head) element strides of each tensor, in order."""
    flat = [t.stride(i) for t in tensors for i in range(3)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(kernel: str, lib: str, fn_name: str, device, *args,
            variant: str = None) -> None:
    """Call ``fn_name`` of library ``lib`` with ``args`` and the current
    stream; raise on a CUDA error, else count the launch under ``kernel``
    (and ``kernel.variant`` when given)."""
    fn = getattr(load(lib), fn_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{err}")
    _count(kernel, *([f"{kernel}.{variant}"] if variant else []))


def fwd_variant(dtype, d: int) -> str:
    """The attention kernels' variant, forward and backward alike, for
    operands of ``dtype`` with head dim ``d``: ``"tc"`` (tensor cores,
    ``csrc/flash_fwd_tc.cu`` and ``csrc/flash_bwd_tc.cu``) for bfloat16
    with ``d <= 128``, else ``"simt"`` (``csrc/flash_fwd.cu`` and
    ``csrc/flash_bwd.cu``).  float32 stays on the CUDA cores: the port
    does f32 work without TF32."""
    return "tc" if dtype == torch.bfloat16 and d <= 128 else "simt"


bwd_variant = fwd_variant


def _resolve_variant(fn: str, q, variant) -> str:
    """``variant`` if the operands allow it, else raise; None picks
    :func:`fwd_variant`.  ``"simt"`` takes every dtype and width that
    :func:`_check_attention` lets through."""
    want = fwd_variant(q.dtype, q.shape[3])
    if variant is None:
        return want
    if variant not in VARIANTS:
        raise ValueError(f"{fn}: unknown variant {variant!r}; expected one "
                         f"of {VARIANTS}")
    if variant == "tc" and want != "tc":
        raise ValueError(f"{fn}: variant 'tc' takes bfloat16 with head_dim "
                         f"<= 128; got {q.dtype} with head_dim "
                         f"{q.shape[3]}")
    return variant


def _rows_aligned(t) -> torch.Tensor:
    """``t`` itself if every (batch, seq, head) row starts on a 16-byte
    boundary (the tc kernels copy rows 16 bytes at a time), else a
    contiguous copy, whose rows do (head_dim is a multiple of 8)."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            t.stride(i) % step == 0 for i in range(3) if t.shape[i] > 1):
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       device=t.device).copy_(t)


# Attention kernel -> (library stem, suffix of its C function).
_ATTENTION_LIBS = {"flash_fwd": ("flash_fwd", ""),
                   "flash_bwd_dq": ("flash_bwd", "_dq"),
                   "flash_bwd_dkv": ("flash_bwd", "_dkv")}


def _attention_launch(kernel, variant, ins, outs, q_off, kv_off, causal,
                      window, dh) -> None:
    """Launch attention kernel ``kernel`` of ``variant`` on the operands
    ``ins`` (q, k, v, and for the backward do, lse, dd), writing ``outs``:
    the pointers, then (simt only) the dtype code, then the shape, strides
    and mask arguments of its C signature, and last the true head dim
    ``dh`` of the softmax scale."""
    stem, suffix = _ATTENTION_LIBS[kernel]
    lib = f"{stem}_tc" if variant == "tc" else stem
    if variant == "tc":
        ins = tuple(_rows_aligned(t) if t.dim() == 4 else t for t in ins)
    q, k = ins[0], ins[1]
    b, sq, h, d = q.shape
    dtype = [] if variant == "tc" else [_FLASH_DTYPES[q.dtype]]
    _launch(kernel, lib, f"mpi4torch_{lib}{suffix}", q.device,
            *(t.data_ptr() for t in ins + outs), *dtype, b, h, k.shape[2],
            sq, k.shape[1], d, _strides(*ins), int(q_off), int(kv_off),
            int(bool(causal)), int(window), int(dh), variant=variant)


def flash_fwd(q, k, v, q_off: int, kv_off: int, causal: bool,
              window: int = 0, variant: str = None):
    """Launch the CUDA block-attention forward.

    ``q`` is ``(b, sq, h, d)``, ``k``/``v`` ``(b, sk, h_kv, d)``, all on
    one CUDA device, float32, bfloat16 or float16 (run in float32), last
    dimension contiguous; ``1 <= d <= 512`` (zero-padded to a multiple of
    8); ``h`` a multiple of ``h_kv``; offsets are scalar ints.  ``variant``
    None takes :func:`fwd_variant`'s; ``"tc"`` or ``"simt"`` asks for one
    by name (``"tc"`` raises on what it does not take).  Returns ``(out,
    lse)``: ``out`` like ``q`` (contiguous), ``lse`` float32 ``(b, sq,
    h)``."""
    _check_attention("flash_fwd", q, k, v, causal, window)
    variant = _resolve_variant("flash_fwd", q, variant)
    b, sq, h, d = q.shape
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device), lse
    ins = _kernel_operands((q, k, v))
    out = torch.empty(ins[0].shape, dtype=ins[0].dtype, device=q.device)
    _attention_launch("flash_fwd", variant, tuple(ins), (out, lse), q_off,
                      kv_off, causal, window, d)
    return _caller_result(out, d, q.dtype), lse


def _check_bwd(fn, q, k, v, do, lse, dd, causal, window) -> None:
    _check_attention(fn, q, k, v, causal, window, more=(("do", do),))
    _check_row_stats(fn, q, (("lse", lse), ("dd", dd)))


def flash_bwd_dq(q, k, v, do, lse, dd, q_off: int, kv_off: int,
                 causal: bool, window: int = 0, variant: str = None):
    """Launch the CUDA block-attention backward's dq kernel.
    ``q``/``k``/``v`` as for :func:`flash_fwd`, ``do`` shaped and typed
    like ``q``; ``lse`` (the forward's) and ``dd`` (``sum(do * out, -1) -
    dlse``) float32 ``(b, sq, h)``.  ``variant`` None takes
    :func:`bwd_variant`'s; ``"tc"`` or ``"simt"`` asks for one by name
    (``"tc"`` raises on what it does not take).  Returns ``dq`` like
    ``q`` (contiguous)."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, dd, causal, window)
    variant = _resolve_variant("flash_bwd_dq", q, variant)
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    d = q.shape[3]
    ins = _kernel_operands((q, k, v, do))
    dq = torch.empty(ins[0].shape, dtype=ins[0].dtype, device=q.device)
    _attention_launch("flash_bwd_dq", variant, (*ins, lse, dd), (dq,),
                      q_off, kv_off, causal, window, d)
    return _caller_result(dq, d, q.dtype)


def flash_bwd_dkv(q, k, v, do, lse, dd, q_off: int, kv_off: int,
                  causal: bool, window: int = 0, variant: str = None):
    """Launch the CUDA block-attention backward's dk/dv kernel; arguments
    as for :func:`flash_bwd_dq`.  Under grouped-query attention each KV
    head's gradient sums its group of q heads inside one block, in a
    fixed order.  Returns ``(dk, dv)`` like ``k`` (contiguous)."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, dd, causal, window)
    variant = _resolve_variant("flash_bwd_dkv", q, variant)
    if k.numel() == 0 or q.shape[1] == 0 or q.shape[2] == 0:
        return (torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device))
    d = k.shape[3]
    ins = _kernel_operands((q, k, v, do))
    dk = torch.empty(ins[1].shape, dtype=ins[1].dtype, device=k.device)
    dv = torch.empty_like(dk)
    _attention_launch("flash_bwd_dkv", variant, (*ins, lse, dd), (dk, dv),
                      q_off, kv_off, causal, window, d)
    return _caller_result(dk, d, k.dtype), _caller_result(dv, d, k.dtype)


# Attention kernel -> (tc library, its props function, leading arguments).
_TC_PROPS = {
    "flash_fwd": ("flash_fwd_tc", "mpi4torch_flash_fwd_tc_props", ()),
    "flash_bwd_dq": ("flash_bwd_tc", "mpi4torch_flash_bwd_tc_props", (0,)),
    "flash_bwd_dkv": ("flash_bwd_tc", "mpi4torch_flash_bwd_tc_props", (1,))}
# The same for the simt variant; its props take the dtype code too.
_SIMT_PROPS = {
    "flash_fwd": ("flash_fwd", "mpi4torch_flash_fwd_props", ()),
    "flash_bwd_dq": ("flash_bwd", "mpi4torch_flash_bwd_props", (0,)),
    "flash_bwd_dkv": ("flash_bwd", "mpi4torch_flash_bwd_props", (1,))}


def _props(lib, fn, args) -> dict:
    out = (ctypes.c_int * 5)()
    err = getattr(load(lib), fn)(*args, out)
    if err != 0:
        raise RuntimeError(f"{lib} props failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "blocks_per_sm"), out))


def tc_props(kernel: str, d: int) -> dict:
    """What the compiler and the card made of the tc variant of attention
    kernel ``kernel`` (``"flash_fwd"``, ``"flash_bwd_dq"`` or
    ``"flash_bwd_dkv"``) at head dim ``d``: registers per thread,
    local-memory (spill) bytes per thread, static and dynamic shared
    memory per block, and the blocks that fit on one SM.  Needs the
    card."""
    lib, fn, lead = _TC_PROPS[kernel]
    return _props(lib, fn, (*lead, int(d)))


def simt_props(kernel: str, dtype, d: int) -> dict:
    """:func:`tc_props` for the simt variant, whose instantiation depends
    on the operand dtype (float32 or bfloat16) too."""
    lib, fn, lead = _SIMT_PROPS[kernel]
    return _props(lib, fn, (*lead, _FLASH_DTYPES[dtype],
                            padded_head_dim(d)))


def hop_vec(block: int, floats, int8s) -> int:
    """The width of the quantized hop kernel's accesses for these operands
    (``None`` entries ignored): 4 (char4 / float4) when the block is whole
    4-element groups, the float32 operands are 16-byte aligned and the
    int8 ones 4-byte aligned; otherwise 1, element by element."""
    aligned = (all(t.data_ptr() % 16 == 0 for t in floats if t is not None)
               and all(t.data_ptr() % 4 == 0 for t in int8s
                       if t is not None))
    return 4 if block % 4 == 0 and aligned else 1


def quant_hop(q, scale, mine, noise=None, want_resid: bool = False):
    """Launch the CUDA quantized ring hop (``csrc/quant_hop.cu``).

    ``mine`` is float32 ``(nb, block)`` on a CUDA device; ``q`` int8 of
    the same shape with ``scale`` float32 ``(nb,)``, or both ``None`` for
    hop 0; ``noise`` float32 like ``mine`` or ``None``.  All contiguous,
    on one device.  Returns ``(q', scale', resid)`` (``resid`` float32
    like ``mine`` when ``want_resid``, else ``None``)."""
    fn = "quant_hop"
    if not isinstance(mine, torch.Tensor) or not mine.is_cuda:
        raise ValueError(f"{fn}: mine must be a CUDA tensor")
    if mine.dtype != torch.float32 or mine.dim() != 2:
        raise ValueError(f"{fn}: mine must be float32 (nb, block), got "
                         f"{mine.dtype} {tuple(mine.shape)}")
    nb, block = mine.shape
    if (q is None) != (scale is None):
        raise ValueError(f"{fn}: q and scale come together (both None for "
                         "hop 0)")
    ops = [("mine", mine, torch.float32, (nb, block))]
    if q is not None:
        ops += [("q", q, torch.int8, (nb, block)),
                ("scale", scale, torch.float32, (nb,))]
    if noise is not None:
        ops.append(("noise", noise, torch.float32, (nb, block)))
    for name, t, dtype, shape in ops:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != mine.device:
            raise ValueError(f"{fn}: every operand must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    q_out = torch.empty((nb, block), dtype=torch.int8, device=mine.device)
    s_out = torch.empty((nb,), dtype=torch.float32, device=mine.device)
    resid = torch.empty_like(mine) if want_resid else None
    if nb == 0 or block == 0:
        return q_out, s_out, resid
    if nb > 2**31 - 1:
        raise ValueError(f"{fn}: {nb} blocks exceed the grid limit 2^31 - 1")
    vec = hop_vec(block, [mine, noise, resid], [q, q_out])
    ptr = (lambda t: None if t is None else t.data_ptr())
    _launch("q8_requant" if q is None else "q8_hop", "quant_hop",
            "mpi4torch_quant_hop", mine.device, ptr(q), ptr(scale),
            mine.data_ptr(), ptr(noise), q_out.data_ptr(), s_out.data_ptr(),
            ptr(resid), nb, block, vec)
    return q_out, s_out, resid
