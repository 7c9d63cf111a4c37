"""Build and bind the CUDA kernels of ``uc2_torch/csrc``.

The sources are compiled at first use, never at import: ``nvcc`` turns
each ``.cu`` into an object for ``sm_90a`` (all sources at once, one
process each), links them into one shared library with a plain C
interface, and ``ctypes`` loads it. The library's name carries a digest of
the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Build outputs go to ``build/uc2_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``); ``build.log`` there keeps
the compiler's report (registers, shared memory, spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uc2_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits; seeds and dropout
# thresholds as unsigned 32-bit ints)
_SIGNATURES = {
    "uc2_attn_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    "uc2_attn_bf16_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    "uc2_attn_train_bwd_dq": [_P] * 8 + [_I] * 4 + [_F, _U, _U, _F] + [_I] * 3
    + [_P],
    "uc2_attn_train_bwd_dkdv": [_P] * 10 + [_I] * 4 + [_F, _U, _U, _F, _I, _P],
    "uc2_fused_attn_block": [_P] * 10 + [_I] * 4 + [_F, _F, _P],
    "uc2_fused_ffn_block": [_P] * 8 + [_I, _I, _F, _P],
    "uc2_fused_ffn_block_partial": [_P] * 5 + [_I, _I, _P],
    "uc2_fused_attn_block_partial": [_P] * 6 + [_I] * 4 + [_F, _P],
    "uc2_fused_layer_block": [_P] * 16 + [_I] * 5 + [_F, _F, _P],
    "uc2_attn_train_fwd": [_P] * 5 + [_I] * 4 + [_F, _U, _U, _F] + [_I] * 3
    + [_P],
    "uc2_ffn_train_fwd": [_P] * 8 + [_I, _I, _F, _U, _U, _F, _I, _P],
    "uc2_ffn_train_bwd": [_P] * 15 + [_I] * 3 + [_F, _U, _U, _F, _I, _P],
    "uc2_fused_attn_block_v2": [_P] * 9 + [_I] * 3 + [_F, _F, _P],
    "uc2_fused_attn_block_v2_partial": [_P] * 6 + [_I] * 3 + [_F, _P],
    "uc2_ffn_train_fwd_partial": [_P] * 6 + [_I, _I, _U, _U, _F, _I, _P],
    "uc2_ffn_train_bwd_partial": [_P] * 11 + [_I] * 3 + [_U, _U, _F, _I, _P],
    "uc2_segment_flash_fwd": [_P] * 6 + [_I] * 4 + [_F, _P],
    "uc2_segment_flash_bwd_dq": [_P] * 9 + [_I] * 4 + [_F, _P],
    "uc2_segment_flash_bwd_dkdv": [_P] * 9 + [_I] * 4 + [_F, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("uc2_torch: nvcc not found (needed to build the CUDA "
                       "kernels on first use)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libuc2_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this version of the sources has no library
    yet; returns the library's path."""
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"uc2_torch: nvcc failed on {failed}:\n"
                               + "\n".join(log))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib)]
            + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"uc2_torch: linking the kernels failed:\n"
                               f"{link.stdout}")
        os.replace(tmp_lib, target)
    return target


def build_log() -> str:
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and bound once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.uc2_cuda_error_string.argtypes = [ctypes.c_int]
        lib.uc2_cuda_error_string.restype = ctypes.c_char_p
        lib.uc2_ffn_train_bwd_workspace.argtypes = [_I] * 4
        lib.uc2_ffn_train_bwd_workspace.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call the C entry ``name`` on ``device``'s current stream and raise
    if the launch was refused (the entry returns cudaGetLastError())."""
    lib = load()
    with torch.cuda.device(device):   # the runtime launches on the current context
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.uc2_cuda_error_string(err).decode()
        raise RuntimeError(f"uc2_torch: {name} failed: CUDA error {err} "
                           f"({msg})")
