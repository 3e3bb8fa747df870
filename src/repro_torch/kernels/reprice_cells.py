"""The fault re-pricing over the carried gain: ``(a, gamma)`` in one pass.

Replaces no TPU kernel.  Under cell faults the incremental engine re-prices
every UE against the masked power ``P`` from the carried gain matrices
(``radio.radio_update_cells``); the JAX package leaves that to XLA, and the
port's torch version made several full passes over the 1M x 127 carried
gain on every TTI of a fault run.  Two versions of one function live here:

* :func:`reprice_cells` -- for CUDA tensors it launches the hand-written
  kernel of ``csrc/reprice_cells.cu`` (built at first use, see
  ``kernels/build.py``) and counts the launch in
  ``reprice_cells.launches``; for CPU tensors it runs the plain version.  A
  CUDA tensor never reaches the plain version: the kernel launches or the
  call raises.
* :func:`reprice_cells_plain` -- the same function as the torch route of
  ``radio.radio_update_cells`` computes it (``rsrp``, the row sum,
  ``best_cell``, ``sinr``).  The CPU tests use it, and ``chip_smoke.py``
  holds the kernel against it on the card.

Bound on the card: bytes, one read of the carried gain.  The kernel reads
each UE row once into shared memory (tiles of a multiple of 4 rows, so a
tile of 127-float rows starts 16-byte aligned), computes each link's RSRP
once as a rounded product and feeds it to the measurement, the
lowest-index argmax and the cell total; it writes only ``a`` and ``gamma``.
At K = 1 the attachment is bit-equal to the plain version; the total, and
so ``gamma``, is summed in another order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.sim import radio


def _check(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32; got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(G, P, G0):
    """``(n, m, k)`` of a call: G (N, M) or (N, M, K), P (M, K), G0 None
    or (N, M), float32, contiguous, on one device."""
    if not isinstance(G, torch.Tensor) or G.dim() not in (2, 3):
        raise ValueError("G must be an (N, M) or (N, M, K) tensor")
    if not isinstance(P, torch.Tensor) or P.dim() != 2:
        raise ValueError("P must be an (M, K) tensor")
    n, m = G.shape[:2]
    k = P.shape[1]
    _check("G", G, (n, m) if G.dim() == 2 else (n, m, k), G.device)
    _check("P", P, (m, k), G.device)
    if G0 is not None:
        _check("G0", G0, (n, m), G.device)
    return n, m, k


def reprice_cells_plain(G, P, noise_w: float, G0=None):
    """Plain PyTorch version: ``(a (N,) int32, gamma (N, K))``.  The
    attachment ranks the measurement of ``G0`` where it is given (the
    unfaded gain: attachment on the mean), else of ``G``."""
    _validate(G, P, G0)
    R = radio.rsrp(G, P)
    meas = (R if G0 is None else radio.rsrp(G0, P)).sum(dim=2)
    a = radio.best_cell(meas)
    gamma, _, _ = radio.sinr(R, a, noise_w)
    return a, gamma


_KERNEL = None


def _kernel():
    """(launch function, shared-memory function, max K) of
    ``csrc/reprice_cells.cu``, built at first use; the ctypes signatures
    are set once, here."""
    global _KERNEL
    if _KERNEL is None:
        lib, _ = build.load("reprice_cells")
        fn = lib.reprice_cells_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        smem = lib.reprice_cells_smem_bytes
        smem.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        max_k = lib.reprice_cells_max_k
        max_k.restype = ctypes.c_int
        max_k.argtypes = []
        _KERNEL = (fn, smem, max_k())
    return _KERNEL


def _launch(G, P, noise_w, G0=None):
    n, m, k = _validate(G, P, G0)
    if n == 0 or m == 0:
        raise ValueError(f"reprice_cells kernel needs at least one UE and "
                         f"one cell; got N={n}, M={m}")
    for name, x in (("G", G), ("G0", G0)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel copies its tiles 16 bytes at a time)")
    fn, smem, max_k = _kernel()
    if k > max_k:
        raise ValueError(f"reprice_cells kernel takes at most {max_k} "
                         f"frequency chunks; got {k}")
    if smem(m, k, int(G.dim() == 3), int(G0 is not None), None) < 0:
        raise ValueError(f"reprice_cells kernel holds two tiles of at least 4 "
                         f"UE rows in shared memory, which does not fit at "
                         f"M={m}, K={k} with this gain layout")
    dev = G.device
    a = torch.empty((n,), dtype=torch.int32, device=dev)
    gamma = torch.empty((n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(G.data_ptr(), 0 if G0 is None else G0.data_ptr(),
                 P.data_ptr(), noise_w, a.data_ptr(), gamma.data_ptr(), n, m,
                 k, int(G.dim() == 3), stream)
    if err != 0:
        raise RuntimeError(
            f"reprice_cells kernel launch failed: CUDA error {err}")
    reprice_cells.launches += 1
    return a, gamma


def reprice_cells(G, P, noise_w: float, G0=None):
    """``(a, gamma)`` of every UE row of the carried gain ``G`` (N, M) or
    (N, M, K) under the powers ``P`` (M, K): the lowest-index argmax of
    the measurement (of ``G0`` (N, M) where it is given) and the SINR
    against the serving cell.  float32, contiguous, on one device."""
    if G.device.type == "cpu":
        return reprice_cells_plain(G, P, noise_w, G0)
    if G.device.type != "cuda":
        raise ValueError(f"reprice_cells runs on CUDA or CPU tensors; got "
                         f"{G.device}")
    return _launch(G, P, noise_w, G0)


#: launches of the CUDA kernel (never counts the plain version)
reprice_cells.launches = 0

#: float32 operations per link and frequency chunk, as the plain version
#: writes them: the RSRP product, its share of the measurement sum and of
#: the cell total; and per link the argmax compare
OPS_PER_LINK_K = 3
OPS_ARGMAX = 1


def gamma_excess(gamma, want, m) -> float:
    """The largest ``|gamma - want|`` over the kernel's bound against the
    plain version's ``want``, ``want * (2 M u (1 + want) + 8 u)`` with
    ``u = 2^-24`` (<= 1 holds): the cell total is a sum of M non-negative
    terms taken in two orders, each within (M - 1) u of it, which
    ``total - w`` and the division carry to gamma."""
    u = 2.0 ** -24
    want64 = want.double()
    tol = want64 * (2 * m * u * (1 + want64) + 8 * u)
    return float(((gamma.double() - want64).abs()
                  / tol.clamp_min(1e-300)).max())


def work(n, m, k):
    """``(operations, bytes)`` of one call on ``n`` UE rows of an (n, m)
    gain under (m, k) powers: each input read once, ``a`` and ``gamma``
    written once."""
    ops = n * m * (OPS_PER_LINK_K * k + OPS_ARGMAX)
    return ops, 4 * (n * m + m * k) + 4 * n * (1 + k)
