"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own plain `nvcc` process, all
started together, and one more `nvcc` links the objects into one shared
library with an `extern "C"` interface, loaded with ctypes. No PyTorch
header is included and `torch.utils.cpp_extension` is not used, so a build
takes seconds.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libvmt_kernels.so"

LAUNCH_COUNTS: dict[str, int] = {
    "fused_temporal_block": 0,
    "linear_stats": 0,
    "linear_apply": 0,
    "temporal_bwd": 0,
    "linear_bwd_head": 0,
    "linear_bwd_merged": 0,
    "temporal_fwd_p": 0,
    "linear_head": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, gamma, w_all, w_out, bias, ek, ev, out, acc (scratch), p (null:
    # no softmax weights out), B, F, S, C, T, heads, stream
    "vmt_temporal_block_fwd": [_P] * 10 + [_I] * 6 + [_P],
    # x, gamma, w_qkv, ek, ev, part_ctx, part_z, ctx, z,
    # BF, N, C, Mc, heads, tile, inv_hw, stream
    "vmt_linear_stats": [_P] * 9 + [_I] * 6 + [_F, _P],
    # x, gamma, w_qkv, w_out, out_bias, ctx, z, out,
    # BF, N, C, heads, tile, scale, stream
    "vmt_linear_apply": [_P] * 8 + [_I] * 5 + [_F, _P],
    # x, gamma, w_all, w_outT, bias, ek, ev, g, dx, dgamma, dw_all, dw_out,
    # dbias, dekv, workspace, B, F, S, C, T, heads, stream
    "vmt_temporal_block_bwd": [_P] * 15 + [_I] * 6 + [_P],
    # x, gamma, w_qkv, w_outT, ek, ev, g, dx, dgamma, dw_qkv, dw_out,
    # dout_bias, dek, dev, workspace, BF, N, C, Mc, heads, scale, inv_hw,
    # clip, stream
    "vmt_linear_block_bwd": [_P] * 15 + [_I] * 5 + [_F, _F, _I, _P],
    # x, gamma, w_qkv, w_out, out_bias, ek, ev, out, workspace, BF, N, C, Mc,
    # heads, apply tile, scale, inv_hw, stream
    "vmt_linear_head": [_P] * 9 + [_I] * 6 + [_F, _F, _P],
}
# sizes in bytes: the workspaces of the entry points that take one, and
# the dynamic shared memory of the temporal and linear kernels' stages
_SIZE_SIGNATURES = {
    "vmt_temporal_block_bwd_workspace": [_I] * 5,     # B, F, S, C, T
    "vmt_linear_block_bwd_workspace": [_I] * 3,       # BF, N, C
    "vmt_linear_head_workspace": [_I] * 2,            # BF, N
    "vmt_temporal_block_fwd_smem": [_I] * 3,         # C, T, stage
    "vmt_temporal_block_bwd_smem": [_I] * 3,         # C, T, stage
    "vmt_linear_block_fwd_smem": [_I] * 2,           # C, stage
    "vmt_linear_block_bwd_smem": [_I] * 2,           # C, stage
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
    Returns {'path', 'built', 'seconds', 'log'}: nvcc's output, also of the
    build that a cached library came from."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        log_path = out_dir / "build.log"
        return {"path": str(lib_path), "built": False, "seconds": 0.0,
                "log": log_path.read_text() if log_path.exists() else ""}
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(proc.returncode)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
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
    for name, argtypes in _SIZE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_size_t
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


def workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """Scratch of a backward launch: one byte tensor the kernel carves."""
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def plain_cotangents(fn, x, g, rest, **kw):
    """The backward twins' autograd: the cotangents of fn(x, *rest, **kw)
    against g, at float32 leaves of `rest` (x keeps its dtype), in the order
    (x, *rest); None operands stay None."""
    leaves = [x.detach()] + [None if t is None else t.detach().float()
                             for t in rest]
    want = [t for t in leaves if t is not None]
    with torch.enable_grad():
        for t in want:
            t.requires_grad_(True)
        out = fn(*leaves, **kw)
        grads = iter(torch.autograd.grad(out, want, g.to(out.dtype)))
    return tuple(None if t is None else next(grads) for t in leaves)


def require_aligned(*tensors) -> None:
    """The kernels copy and load 16 bytes at a time: every operand must
    start on a 16-byte boundary (None operands are skipped)."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("operands must start on a 16-byte boundary")


def require(cond: bool, what: str) -> None:
    """Input check of a kernel wrapper: raise on what the kernel does not
    take."""
    if not cond:
        raise ValueError(what)
