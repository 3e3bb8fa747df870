"""Pairwise UE-cell distances (the D block): ``(d2d, d3d)``.

Replaces the Pallas TPU kernel ``repro.kernels.pairwise_dist.pairwise_dist``.
Two versions of one function live here:

* :func:`pairwise_dist` -- for CUDA tensors it launches the hand-written
  kernel of ``csrc/pairwise_dist.cu`` (built at first use, see
  ``kernels/build.py``) and counts the launch in
  ``pairwise_dist.launches``; for CPU tensors it runs the plain version.  A
  CUDA tensor never reaches the plain version: the kernel launches or the
  call raises.
* :func:`pairwise_dist_plain` -- the same function in plain PyTorch: the
  port's ``radio.compute_distances`` without the bearing.  The CPU tests
  use it, and ``chip_smoke.py`` holds the kernel against it on the card.

Both subtract directly.  The TPU kernel's MXU expansion
``|u|^2 + |c|^2 - 2 u.c`` loses up to ~0.2 m to cancellation at a 5 km
extent and is not carried over.  Bound on the card: bytes, 8 per link
written.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _validate(U, C):
    for name, x in (("U", U), ("C", C)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must have shape (n, 3); got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if U.device != C.device:
        raise ValueError(f"U is on {U.device} and C on {C.device}")
    return U.shape[0], C.shape[0]


def pairwise_dist_plain(U, C):
    """Plain PyTorch version: (d2d, d3d), each (N, M) float32."""
    _validate(U, C)
    dx = U[:, None, 0] - C[None, :, 0]
    dy = U[:, None, 1] - C[None, :, 1]
    dz = U[:, None, 2] - C[None, :, 2]
    d2d = torch.sqrt(dx * dx + dy * dy)
    d3d = torch.sqrt(d2d * d2d + dz * dz)
    return d2d, d3d


def _launch(U, C):
    n, m = _validate(U, C)
    if n == 0 or m == 0:
        raise ValueError(f"pairwise_dist kernel needs at least one UE and "
                         f"one cell; got N={n}, M={m}")
    lib, _ = build.load("pairwise_dist")
    d2d = torch.empty((n, m), dtype=torch.float32, device=U.device)
    d3d = torch.empty((n, m), dtype=torch.float32, device=U.device)
    fn = lib.pairwise_dist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = fn(U.data_ptr(), C.data_ptr(), d2d.data_ptr(), d3d.data_ptr(),
                 n, m, stream)
    if err != 0:
        raise RuntimeError(
            f"pairwise_dist kernel launch failed: CUDA error {err}")
    pairwise_dist.launches += 1
    return d2d, d3d


def pairwise_dist(U, C):
    """(d2d, d3d) distance matrices of UE rows ``U`` (N, 3) and cells ``C``
    (M, 3), float32 and contiguous on one device.  The CUDA kernel masks
    ragged edges itself, so nothing is padded."""
    if U.device.type == "cpu":
        return pairwise_dist_plain(U, C)
    if U.device.type != "cuda":
        raise ValueError(f"pairwise_dist runs on CUDA or CPU tensors; got "
                         f"{U.device}")
    return _launch(U, C)


#: launches of the CUDA kernel (never counts the plain version)
pairwise_dist.launches = 0

#: float32 operations per link (3 sub, 4 mul, 2 add, 2 sqrt), as the plain
#: version writes them
OPS_PER_LINK = 11


def work(n, m):
    """``(operations, bytes)`` of one call on ``n`` UEs and ``m`` cells:
    each input read once, both (n, m) outputs written once."""
    return n * m * OPS_PER_LINK, 8 * n * m + 12 * (n + m)
