"""The port's hand-written CUDA kernels, built and bound at first use.

The kernels (`csrc/chunk_conv.cu`, `csrc/chunk_conv_bwd.cu`,
`csrc/segsum.cu`, `csrc/bce_loss.cu` and `csrc/gather_conv.cu` in this
package, with the shared `csrc/chunk_conv.cuh`) are compiled by `nvcc` for `sm_90a` into one shared library with a plain C
interface and loaded through ctypes: no PyTorch headers, so the build
takes seconds. Pointers and the stream go over as `ctypes.c_void_p`; each
entry returns a `cudaError_t` that `check` turns into an exception.
Nothing here runs at import: the CPU tests import these modules on a
machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from occuseg_tpu_torch._build import PKG_DIR, build_shared_library

_SOURCES = tuple(os.path.join(PKG_DIR, "csrc", f)
                 for f in ("chunk_conv.cu", "chunk_conv_bwd.cu", "segsum.cu",
                           "bce_loss.cu", "gather_conv.cu"))
_HEADERS = (os.path.join(PKG_DIR, "csrc", "chunk_conv.cuh"),)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_int = ctypes.c_int


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def library_path() -> str:
    """Build the kernel library if needed; return its path."""
    return build_shared_library("occ_kernels", _SOURCES, (_nvcc(),),
                                NVCC_FLAGS, _HEADERS)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; raises on failure."""
    lib = ctypes.CDLL(library_path())
    lib.occ_chunk_conv_fwd.restype = _int
    lib.occ_chunk_conv_fwd.argtypes = [_vp, _int, _int, _vp, _int, _int, _vp,
                                       _int, _int, _vp, _int, _vp, _int, _vp]
    lib.occ_chunk_conv_bwd_fused.restype = _int
    lib.occ_chunk_conv_bwd_fused.argtypes = [_vp, _int, _int, _vp, _int, _int,
                                             _vp, _int, _int, _vp, _vp, _int,
                                             _vp, _vp, _int, _vp]
    lib.occ_chunk_conv_dw.restype = _int
    lib.occ_chunk_conv_dw.argtypes = [_vp, _int, _int, _vp, _int, _int, _vp,
                                      _int, _int, _vp, _int, _int, _vp, _vp,
                                      _int, _vp]
    lib.occ_blocked_segment_sum.restype = _int
    lib.occ_blocked_segment_sum.argtypes = [_vp, _int, _vp, _int, _int, _int,
                                            _vp, _vp]
    lib.occ_bce_radius.restype = _int
    lib.occ_bce_radius.argtypes = [_vp, _vp, _int, _vp, _vp, _int, _vp, _int,
                                   _vp]
    lib.occ_bce_fwd.restype = _int
    lib.occ_bce_fwd.argtypes = [_vp, _int, _int, _vp, _vp, _vp, _vp, _vp, _vp,
                                _vp, _int, _int, _int, _vp, _vp, _vp]
    lib.occ_bce_bwd.restype = _int
    lib.occ_bce_bwd.argtypes = [_vp, _int, _int, _vp, _vp, _vp, _vp, _vp, _vp,
                                _vp, _int, _vp, _int, _int, _vp, _vp, _vp,
                                _vp, _vp, _vp, _vp]
    lib.occ_gather_conv.restype = _int
    lib.occ_gather_conv.argtypes = [_vp, _int, _int, _vp, _int, _vp, _int, _vp,
                                    _int, _vp]
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a failure (a cudaError_t, or one of the
    entry's own negative codes)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with code {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_input(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """Device, dtype, rank, contiguity and 16-byte alignment checks for a
    tensor handed to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"{name} requires grad, but a kernel wrapper is "
                           f"not differentiable: differentiate through its "
                           f"autograd entry point (chunk_conv."
                           f"chunk_gather_conv / chunk_gather_conv_t, "
                           f"bce_loss.bce_membership_sums), or call it "
                           f"under torch.no_grad")
