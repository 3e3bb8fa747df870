"""The fused CRRM pipeline D -> G -> RSRP -> (total, argmax, serving row).

Replaces the Pallas TPU kernel ``repro.kernels.fused_sinr
.fused_sinr_accumulate``.  Two versions of one function live here:

* :func:`fused_sinr_accumulate` -- for CUDA tensors it launches the
  hand-written kernel of ``csrc/fused_sinr.cu`` (built at first use, see
  ``kernels/build.py``) and counts the launch in
  ``fused_sinr_accumulate.launches``; for CPU tensors it runs the plain
  version.  A CUDA tensor never reaches the plain version: the kernel
  launches or the call raises.
* :func:`fused_sinr_accumulate_plain` -- the same function in plain
  PyTorch, materialising the (N, M[, K]) matrices.  The CPU tests use it,
  and ``chip_smoke.py`` holds the kernel against it on the card.

Bound on the card: with no fading the kernel is arithmetic bound (several
``log10f``, a ``powf`` and two ``sqrtf`` per link, plus ``atan2f``/``sinf``/
``cosf``/``powf`` when sectored) on a few bytes of input per UE; with
per-RB fading, reading the (N, M, K) tensor once sets a byte bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(U, C, Pw, boresight, fad, attach_on_mean):
    n, m, k = U.shape[0], C.shape[0], Pw.shape[1]
    dev = U.device
    f32 = torch.float32
    _check("U", U, (n, 3), f32, dev)
    _check("C", C, (m, 3), f32, dev)
    _check("Pw", Pw, (m, k), f32, dev)
    _check("boresight", boresight, (m,), f32, dev)
    if fad is None:
        if attach_on_mean:
            raise ValueError("attach_on_mean requires a fading tensor")
        mode = 0
    elif fad.dim() == 2:
        _check("fad", fad, (n, m), f32, dev)
        mode = 1
    else:
        _check("fad", fad, (n, m, k), f32, dev)
        mode = 2
    return n, m, k, mode


def fused_sinr_accumulate_plain(U, C, Pw, boresight, fad=None, *,
                                pathgain_fn, n_sectors: int = 1,
                                attach_on_mean: bool = False):
    """Plain PyTorch version.  Returns (total (N, K), best_val (N, 1),
    best_idx (N, 1) int32, w_best (N, K)), like the TPU kernel."""
    n, m, k, mode = _validate(U, C, Pw, boresight, fad, attach_on_mean)
    dx = U[:, None, 0] - C[None, :, 0]
    dy = U[:, None, 1] - C[None, :, 1]
    dz = U[:, None, 2] - C[None, :, 2]
    d2d = torch.sqrt(dx * dx + dy * dy)
    d3d = torch.sqrt(d2d * d2d + dz * dz)
    g = pathgain_fn(d2d, d3d, C[:, 2][None, :], U[:, 2][:, None])
    if n_sectors > 1:
        off = torch.atan2(dy, dx) - boresight[None, :]
        off = torch.atan2(torch.sin(off), torch.cos(off))
        phi3 = 1.1344640137963142  # 65 deg in radians
        att = torch.clamp(12.0 * (off / phi3) ** 2, max=30.0)
        g = g * torch.pow(10.0, 0.1 * (0.0 - att))
    mean = g[:, :, None] * Pw[None, :, :]
    if mode == 0:
        r = mean
    elif mode == 1:
        r = (g * fad)[:, :, None] * Pw[None, :, :]
    else:
        r = (g[:, :, None] * fad) * Pw[None, :, :]
    meas = (mean if attach_on_mean else r).sum(dim=2)
    total = r.sum(dim=1)
    best_val = meas.max(dim=1).values
    best_idx = torch.argmax(meas, dim=1)      # first maximum: lowest index
    w_best = torch.gather(r, 1, best_idx[:, None, None].expand(n, 1, k))[:, 0]
    return (total, best_val[:, None], best_idx.to(torch.int32)[:, None],
            w_best)


def _launch(U, C, Pw, boresight, fad, *, pathgain_fn, n_sectors,
            attach_on_mean):
    n, m, k, mode = _validate(U, C, Pw, boresight, fad, attach_on_mean)
    spec = getattr(pathgain_fn, "kernel_spec", None)
    if spec is None:
        raise ValueError(
            f"the fused CUDA kernel cannot express pathgain_fn "
            f"{pathgain_fn!r}: only the PATHLOSS_MODELS of "
            f"repro_torch.sim.pathloss describe themselves to it")
    model_id, params = spec()
    lib, _ = build.load("fused_sinr")
    if k > lib.fused_sinr_max_k():
        raise ValueError(f"the fused CUDA kernel takes at most "
                         f"{lib.fused_sinr_max_k()} frequency chunks; got {k}")
    if len(params) > lib.fused_sinr_max_pl_params():
        raise ValueError(f"pathloss model needs {len(params)} kernel "
                         f"parameters; the kernel takes at most "
                         f"{lib.fused_sinr_max_pl_params()}")
    dev = U.device
    total = torch.empty((n, k), dtype=torch.float32, device=dev)
    w_best = torch.empty((n, k), dtype=torch.float32, device=dev)
    best_val = torch.empty((n, 1), dtype=torch.float32, device=dev)
    best_idx = torch.empty((n, 1), dtype=torch.int32, device=dev)
    plp = (ctypes.c_float * max(1, len(params)))(*params)
    fn = lib.fused_sinr_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(U.data_ptr(), C.data_ptr(), Pw.data_ptr(),
                 boresight.data_ptr(), 0 if fad is None else fad.data_ptr(),
                 total.data_ptr(), best_val.data_ptr(), best_idx.data_ptr(),
                 w_best.data_ptr(), n, m, k, mode, int(attach_on_mean),
                 int(n_sectors), model_id, plp, len(params), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sinr kernel launch failed: CUDA error {err}")
    fused_sinr_accumulate.launches += 1
    return total, best_val, best_idx, w_best


def fused_sinr_accumulate(U, C, Pw, boresight, fad=None, *, pathgain_fn,
                          n_sectors: int = 1, attach_on_mean: bool = False):
    """Run the fused accumulator.  Returns (total, best_val, best_idx, w_best).

    Shapes: U (N, 3), C (M, 3), Pw (M, K), boresight (M,), fad None /
    (N, M) wideband / (N, M, K) per-RB, all float32 on one device.  The
    CUDA kernel masks ragged edges itself, so no padding is needed.
    ``attach_on_mean`` ranks servers on the unfaded RSRP row sum
    (``attach_ignores_fading``); it requires ``fad``.  ``pathgain_fn`` is
    a model of ``repro_torch.sim.pathloss`` (the kernel reads its
    ``kernel_spec``; the plain version calls it).
    """
    kw = dict(pathgain_fn=pathgain_fn, n_sectors=n_sectors,
              attach_on_mean=attach_on_mean)
    if U.device.type == "cpu":
        return fused_sinr_accumulate_plain(U, C, Pw, boresight, fad, **kw)
    if U.device.type != "cuda":
        raise ValueError(f"fused_sinr runs on CUDA or CPU tensors; got "
                         f"{U.device}")
    return _launch(U, C, Pw, boresight, fad, **kw)


#: launches of the CUDA kernel (never counts the plain version)
fused_sinr_accumulate.launches = 0
