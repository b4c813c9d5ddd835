"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled on the machine that holds the card, at first use,
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, and loaded with ``ctypes``.  One ``nvcc -c`` per source runs in
parallel; a link step joins the objects.  The library is cached under a
build directory by a hash of the sources, so an edited source is rebuilt.

Nothing here is touched when the package is imported: ``library()`` is
called by a kernel wrapper only when it is handed a CUDA tensor.  A failed
build raises with the compiler's stderr; no caller catches that to carry on
with a plain PyTorch version.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()`` as an int; ``check`` turns a non-zero
return into a ``RuntimeError``.  A launch is asynchronous: the wrappers may
drop their temporaries right after it because PyTorch's caching allocator
hands a freed block only to later work on the same stream, which runs after
the kernel.  ``LAUNCHES`` counts launches per kernel: a
wrapper adds one where it launches its kernel and nowhere else.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "fused_qkv.cu", "fused_mlp.cu", "attention_probes.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# launches of each hand-written kernel since the last reset_launches()
LAUNCHES = {
    "flash_fwd": 0, "flash_fwd_nomax": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "fused_qkv": 0, "fused_mlp": 0,
    "packed_fwd": 0, "packed_fwd_nomax": 0, "packed_band": 0, "packed_bwd_dq": 0, "packed_bwd_dkv": 0,
    "probe_variant": 0, "probe_exp_dtype": 0,
}

_lib = None
_lib_lock = threading.Lock()
build_seconds = None  # wall time of the build this process did, if it did one


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    """``$SRHEP_TORCH_BUILD_DIR`` or ``build/`` beside the package."""
    env = os.environ.get("SRHEP_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): the CUDA "
        "kernels of superresolutionhep_tpu_torch cannot be built on this machine"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link; returns the library path."""
    global build_seconds
    out_dir = build_dir()
    tag = _source_hash()
    lib_path = out_dir / f"libsrhep_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in SOURCES:
        obj = out_dir / f"{Path(src).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs, errors, logs = [], [], []
    for src, obj, p in procs:
        out, err = p.communicate()
        logs.append(f"== {src}\n{out}{err}")
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {p.returncode}):\n{err}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs], capture_output=True, text=True
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernel library:\n{link.stderr}")
    os.replace(tmp, lib_path)
    build_seconds = time.time() - t0
    if verbose:
        (out_dir / "nvcc_log.txt").write_text("\n".join(logs))
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# name -> argtypes; every pointer and the stream are c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    # q, k, v, qm, km, out, lse, B, H, Lq, Lk, D, strides (b, l, h) of q, k, v,
    # is_bf16, nomax, block_q, stream
    "srhep_flash_fwd": [_P] * 7 + [_I] * 5 + [_L] * 9 + [_I, _I, _I, _P],
    # q, k, v, g, lse, dl, qm, km, dq, B, H, Lq, Lk, D, strides (b, l, h) of
    # q, k, v, g, is_bf16, block_rows, lse/dl row stride, stream
    "srhep_flash_bwd_dq": [_P] * 9 + [_I] * 5 + [_L] * 12 + [_I, _I, _I, _P],
    # the same with dk, dv in place of dq
    "srhep_flash_bwd_dkv": [_P] * 10 + [_I] * 5 + [_L] * 12 + [_I, _I, _I, _P],
    # segment-packed rows: q, k, v, seg, band, out, lse, B, H, S, D, strides
    # (b, l, h) of q, k, v, is_bf16, nomax, block_q, stream
    "srhep_packed_fwd": [_P] * 7 + [_I] * 4 + [_L] * 9 + [_I, _I, _I, _P],
    # seg, band, B, S, block_q, block_k, stream
    "srhep_packed_band": [_P, _P, _I, _I, _I, _I, _P],
    # q, k, v, g, lse, dl, seg, band, dq, B, H, S, D, strides of q, k, v, g,
    # is_bf16, block_rows, lse/dl row stride, stream
    "srhep_packed_bwd_dq": [_P] * 9 + [_I] * 4 + [_L] * 12 + [_I, _I, _I, _P],
    # the same with dk, dv in place of dq
    "srhep_packed_bwd_dkv": [_P] * 10 + [_I] * 4 + [_L] * 12 + [_I, _I, _I, _P],
    # x, a, b, w(O,F), bias, seg, out, M, L, F, O, rows mode, table rows
    # (E + 1), shared memory bytes, is_bf16, stream
    "srhep_fused_qkv": [_P] * 7 + [_I] * 8 + [_P],
    # q, attn, ga, a, b, gm, w0(Fh,F), b0, w1(F,Fh), b1, seg, out, M, L, F,
    # Fh, rows mode, table rows, shared memory bytes, is_bf16, stream
    "srhep_fused_mlp": [_P] * 12 + [_I] * 8 + [_P],
    # probes (B, H, L, D) bf16: q, k, v, out, B, H, L, D, mode, block_q, block_k, stream
    "srhep_probe_variant": [_P] * 4 + [_I] * 7 + [_P],
    # q, k, v, km, out, B, H, L, D, exp_bf16, block_q, block_k, stream
    "srhep_probe_exp_dtype": [_P] * 5 + [_I] * 7 + [_P],
}


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a gradient of any of ``tensors``: a wrapper
    then goes through its ``torch.autograd.Function``, else it launches
    directly."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")
