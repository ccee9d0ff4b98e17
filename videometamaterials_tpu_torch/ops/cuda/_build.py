"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by ONE plain `nvcc` command into one
shared library with an `extern "C"` interface, loaded with ctypes. No
PyTorch header is included and `torch.utils.cpp_extension` is not used, so
a build takes seconds.

The library goes to `build/vmt_torch_kernels/<hash>/` at the root of the
checkout (gitignored), keyed by a hash of the sources and flags, and is
built at first use. A failed build raises with nvcc's output; nothing falls
back to the plain twins. Writes are atomic (build to a temporary name, then
rename), so no lock file is ever left behind.

Each wrapper adds one to its entry of `LAUNCH_COUNTS` right after its
kernel launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "vmt_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libvmt_kernels.so"

LAUNCH_COUNTS: dict[str, int] = {
    "fused_temporal_block": 0,
    "linear_stats": 0,
    "linear_apply": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, gamma, w_all, w_out, bias, ek, ev, out, B, F, S, C, T, heads, stream
    "vmt_temporal_block_fwd": [_P] * 8 + [_I] * 6 + [_P],
    # x, gamma, w_qkv, ek, ev, part_ctx, part_z, ctx, z,
    # BF, N, C, Mc, heads, tile, inv_hw, stream
    "vmt_linear_stats": [_P] * 9 + [_I] * 6 + [_F, _P],
    # x, gamma, w_qkv, w_out, out_bias, ctx, z, out,
    # BF, N, C, heads, tile, scale, stream
    "vmt_linear_apply": [_P] * 8 + [_I] * 5 + [_F, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """Build the library if this checkout has no build of these sources yet.
    Returns {'path', 'built', 'seconds', 'log'}."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return {"path": str(lib_path), "built": False, "seconds": 0.0,
                "log": ""}
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return {"path": str(lib_path), "built": True, "seconds": seconds,
            "log": log}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_info()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vmt_error_string.argtypes = [ctypes.c_int]
    lib.vmt_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib.vmt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Input check of a kernel wrapper: raise on what the kernel does not
    take."""
    if not cond:
        raise ValueError(what)
