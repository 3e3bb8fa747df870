"""The fused CRRM pipeline D -> G -> RSRP -> (total, argmax, serving row).

Replaces the Pallas TPU kernel ``fused_sinr_accumulate``
(``src/repro/kernels/fused_sinr.py:139``).  Two versions of one function
live here:

* :func:`fused_sinr_accumulate` -- for CUDA tensors it launches the
  hand-written kernel of ``csrc/fused_sinr.cu`` (built at first use, see
  ``kernels/build.py``) and counts the launch in
  ``fused_sinr_accumulate.launches``; for CPU tensors it runs the plain
  version.  A CUDA tensor never reaches the plain version: the kernel
  launches or the call raises.
* :func:`fused_sinr_accumulate_plain` -- the same function in plain
  PyTorch, materialising the (R, M[, K]) matrices.  The CPU tests use it,
  and ``chip_smoke.py`` holds the kernel against it on the card.

Both take an optional row index ``idx``: the output rows are then the UE
rows ``idx`` of ``U`` (and of the fading tensor), the engine's dirty rows,
so no caller gathers them.  The kernel reads them by index itself.

The kernel's design: a group of :data:`GROUP` lanes owns one UE row and
strides over the cells; a shuffle merge keeps ``jnp.argmax``'s
lowest-index tie-break.  The pathloss model's constants are folded on the
host (``kernel_spec()`` of ``sim/pathloss.py``), so a link costs one
accurate log2 and one exp2.  Bound on the card: with no fading,
operations (the special-function pipe needs less time than the fp32
one); with per-RB fading, reading the (R, M, K) fading rows once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.sim import pathloss

#: lanes per UE row of every launch: on an H100 the fastest lane group at
#: 100 000 rows for M = 126 to 600 cells, within 6 % of 16 at 10 000 rows
#: (PERF.md)
GROUP = 8
#: lane groups built for the UMa/UMi family at K <= 4, to time and test the
#: kernel at each; every other model and K has GROUP only
GROUP_SIZES = (8, 16, 32)


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


def _check_idx(idx, dev):
    if not isinstance(idx, torch.Tensor):
        raise TypeError("idx must be a tensor")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64; got {idx.dtype}")
    if idx.dim() != 1:
        raise ValueError(f"idx must have shape (R,); got {tuple(idx.shape)}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, expected {dev}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")


def _validate(U, C, Pw, boresight, fad, idx, attach_on_mean):
    n, m, k = U.shape[0], C.shape[0], Pw.shape[1]
    dev = U.device
    f32 = torch.float32
    _check("U", U, (n, 3), f32, dev)
    _check("C", C, (m, 3), f32, dev)
    _check("Pw", Pw, (m, k), f32, dev)
    _check("boresight", boresight, (m,), f32, dev)
    if idx is not None:
        _check_idx(idx, dev)
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


def fused_sinr_accumulate_plain(U, C, Pw, boresight, fad=None, *, idx=None,
                                pathgain_fn, n_sectors: int = 1,
                                attach_on_mean: bool = False):
    """Plain PyTorch version.  Returns (total (R, K), best_val (R, 1),
    best_idx (R, 1) int32, w_best (R, K)), like the TPU kernel; R = N, or
    the length of ``idx``, whose range it checks."""
    n, m, k, mode = _validate(U, C, Pw, boresight, fad, idx, attach_on_mean)
    if idx is not None:
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(f"idx out of range for {n} UE rows")
        rows = idx.long()
        U = U[rows]
        fad = None if fad is None else fad[rows]
    r_n = U.shape[0]
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
    w_best = torch.gather(r, 1, best_idx[:, None, None].expand(r_n, 1, k))
    return (total, best_val[:, None], best_idx.to(torch.int32)[:, None],
            w_best[:, 0])


_KERNEL = None


def _kernel():
    """(launch function, max K, max parameters) of ``csrc/fused_sinr.cu``,
    built at first use; the ctypes signature is set once, here."""
    global _KERNEL
    if _KERNEL is None:
        lib, _ = build.load("fused_sinr")
        fn = lib.fused_sinr_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        _KERNEL = (fn, lib.fused_sinr_max_k(), lib.fused_sinr_max_pl_params())
    return _KERNEL


@functools.lru_cache(maxsize=64)
def _model_params(pathgain_fn):
    """(model id, ctypes float array, length) of a pathloss model: its
    folded constants, computed once per model object."""
    spec = getattr(pathgain_fn, "kernel_spec", None)
    if spec is None:
        raise ValueError(
            f"the fused CUDA kernel cannot express pathgain_fn "
            f"{pathgain_fn!r}: only the PATHLOSS_MODELS of "
            f"repro_torch.sim.pathloss describe themselves to it")
    model_id, params = spec()
    return model_id, (ctypes.c_float * max(1, len(params)))(*params), \
        len(params)


def _launch(U, C, Pw, boresight, fad=None, *, idx=None, pathgain_fn,
            n_sectors=1, attach_on_mean=False, group=None):
    """The CUDA launch behind :func:`fused_sinr_accumulate`.  ``group``
    overrides the lanes per row (default :data:`GROUP`): a hook for timing
    and testing each lane group."""
    n, m, k, mode = _validate(U, C, Pw, boresight, fad, idx, attach_on_mean)
    r_n = n if idx is None else idx.shape[0]
    if r_n == 0 or m == 0:
        raise ValueError(f"the fused CUDA kernel needs at least one row and "
                         f"one cell; got {r_n} rows, M={m}")
    group = GROUP if group is None else group
    model_id, plp, n_pl = _model_params(pathgain_fn)
    if group != GROUP and (group not in GROUP_SIZES or k > 4 or model_id
                           not in (pathloss.PL_UMA, pathloss.PL_UMI)):
        raise ValueError(f"lane group {group} is not built: every model has "
                         f"{GROUP}, UMa and UMi at K <= 4 also {GROUP_SIZES}")
    fn, max_k, max_pl = _kernel()
    if k > max_k:
        raise ValueError(f"the fused CUDA kernel takes at most {max_k} "
                         f"frequency chunks; got {k}")
    if n_pl > max_pl:
        raise ValueError(f"pathloss model needs {n_pl} kernel parameters; "
                         f"the kernel takes at most {max_pl}")
    dev = U.device
    total = torch.empty((r_n, k), dtype=torch.float32, device=dev)
    w_best = torch.empty((r_n, k), dtype=torch.float32, device=dev)
    best_val = torch.empty((r_n, 1), dtype=torch.float32, device=dev)
    best_idx = torch.empty((r_n, 1), dtype=torch.int32, device=dev)
    idx_bits = 0 if idx is None else 8 * idx.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(U.data_ptr(), C.data_ptr(), Pw.data_ptr(),
                 boresight.data_ptr(), 0 if fad is None else fad.data_ptr(),
                 0 if idx is None else idx.data_ptr(), idx_bits,
                 total.data_ptr(), best_val.data_ptr(), best_idx.data_ptr(),
                 w_best.data_ptr(), n, r_n, m, k, mode, int(attach_on_mean),
                 int(n_sectors), group, model_id, plp, n_pl, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sinr kernel launch failed: CUDA error {err}")
    fused_sinr_accumulate.launches += 1
    return total, best_val, best_idx, w_best


def grad_unsupported_reason(**inputs) -> "str | None":
    """``None`` unless autograd records one of the named ``inputs``, else
    why the kernel cannot take them: it has no backward (nor has the TPU
    kernel it replaces), so its outputs would be cut off from the
    gradient.  On CPU tensors the plain version is held to the same rule,
    so a route behaves alike on both devices."""
    if not torch.is_grad_enabled():
        return None
    names = [k for k, x in inputs.items()
             if isinstance(x, torch.Tensor) and x.requires_grad]
    if not names:
        return None
    return (f"{', '.join(names)} require grad and fused_sinr has no "
            f"backward; differentiate through the materialised chain "
            f"(backend='torch', inc_backend='torch') or call under "
            f"torch.no_grad()")


def fused_sinr_accumulate(U, C, Pw, boresight, fad=None, *, idx=None,
                          pathgain_fn, n_sectors: int = 1,
                          attach_on_mean: bool = False):
    """Run the fused accumulator.  Returns (total, best_val, best_idx, w_best).

    Shapes: U (N, 3), C (M, 3), Pw (M, K), boresight (M,), fad None /
    (N, M) wideband / (N, M, K) per-RB, all float32 on one device.
    ``idx`` (R,) int32 or int64 selects the output rows (UE rows of U and
    fad; repeats allowed); without it R = N.  On CUDA the range
    ``0 <= idx < N`` is the caller's contract, not checked here, so that a
    launch costs no device-to-host sync (a row out of range gets NaN and
    attachment -1); the plain version checks it.  The CUDA kernel masks
    ragged edges itself, so no padding is needed.  ``attach_on_mean`` ranks
    servers on the unfaded RSRP row sum (``attach_ignores_fading``); it
    requires ``fad``.  ``pathgain_fn`` is a model of
    ``repro_torch.sim.pathloss`` (the kernel reads its ``kernel_spec``; the
    plain version calls it).
    """
    reason = grad_unsupported_reason(U=U, C=C, Pw=Pw, boresight=boresight,
                                     fad=fad)
    if reason is not None:
        raise ValueError(f"fused_sinr cannot run here: {reason}")
    kw = dict(idx=idx, pathgain_fn=pathgain_fn, n_sectors=n_sectors,
              attach_on_mean=attach_on_mean)
    if U.device.type == "cpu":
        return fused_sinr_accumulate_plain(U, C, Pw, boresight, fad, **kw)
    if U.device.type != "cuda":
        raise ValueError(f"fused_sinr runs on CUDA or CPU tensors; got "
                         f"{U.device}")
    return _launch(U, C, Pw, boresight, fad, **kw)


#: launches of the CUDA kernel (never counts the plain version)
fused_sinr_accumulate.launches = 0

# float32 operations per link, one per arithmetic op or transcendental call:
# the work of the function as the plain version writes it, fixed when the
# kernel was first ported so that every kernel time is held to the same
# bound; they are not recounted from the redesigned csrc/fused_sinr.cu
OPS_DIST = 11                # 3 sub, 4 mul, 2 add, 2 sqrt
# sector: atan2, sub, sin, cos, atan2, div, 2 mul, min, sub, mul, pow
OPS_SECTOR = 12
#: pathloss + pow, by the model id of ``kernel_spec()``
OPS_MODEL = {pathloss.PL_RMA: 60, pathloss.PL_RMA_DISCRETISED: 30,
             pathloss.PL_UMA: 36, pathloss.PL_UMI: 36, pathloss.PL_INH: 16,
             pathloss.PL_POWER_LAW: 3}
OPS_PER_K = 6                # fading mul, power mul, 2 adds, mean mul-add
OPS_ARGMAX = 1


def work(n, m, k, fad_floats, model_id, n_sectors, idx_bytes=0):
    """``(operations, bytes)`` of one call on ``n`` rows against ``m``
    cells and ``k`` frequency chunks: the float32 operations per link above
    times the links, and the bytes read once and written once.
    ``fad_floats`` of fading and ``idx_bytes`` of row index are what the
    ``n`` rows read; ``model_id`` is the pathloss model's
    ``kernel_spec()[0]``."""
    in_bytes = 4 * (3 * n + 3 * m + m * k + m) + 4 * fad_floats + idx_bytes
    out_bytes = 4 * (2 * n * k + 2 * n)
    ops = n * m * (OPS_DIST + OPS_MODEL[model_id] + k * OPS_PER_K
                   + OPS_ARGMAX + (OPS_SECTOR if n_sectors > 1 else 0))
    return ops, in_bytes + out_bytes
