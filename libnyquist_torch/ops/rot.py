"""CELT spreading rotation over the raw-iy leaf plane: plain version + CUDA
kernel.

The decoder's exp_rotation (reference: celt/vq.c:77, decode direction)
spreads each PVQ leaf with Givens sweeps: per sub-segment a forward and
a backward sweep at stride sigma with swapped coefficients, then both at
lag 1, then the per-leaf gain. Here it runs over the whole dense plane
at once. The planes are position-major ``[W, R]``: W band positions
(100 << LM, 800 for 20 ms frames) by R rows, the device replay's
channel-major rows ``c * F + f`` (ops/celt_replay.py). Sparse markers say
where sub-segments start: ``pk`` packs
``column << 13 | sub-segment length << 4 | lag`` (lag = 1 + sigma for a
rotating sub-segment, 1 otherwise; -1 = no marker), ``th`` the rotation
angle parameter theta (0 = no rotation) and ``g`` the leaf's final gain.

``rotate_plane`` dispatches on the tensor's device: a CPU tensor goes to
the plain PyTorch version ``rotate_plane_ref``; a CUDA tensor goes to
the hand-written kernel (``csrc/rot.cu``) through ``rotate_plane_cuda``,
or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels

MAX_SIGMA_CLASSES = 15


def _sigma_lo_col(sigma, band_off):
    """First column of the first band wide enough for sigma2 = sigma: a
    sub-segment needs len > ((sigma-1)^2 + (sigma-1)) * stride, and
    segments never span bands."""
    need = (sigma - 1) * (sigma - 1) + (sigma - 1) + 1
    for i in range(len(band_off) - 1):
        if band_off[i + 1] - band_off[i] >= need:
            return int(band_off[i])
    return int(band_off[-1])


def _classes(sigmas, band_off):
    """The sweep classes in order: (sigma, first column, swapped coefs)
    per sigma class, then the lag-1 class over every column."""
    sigmas = tuple(int(s) for s in sigmas)
    if len(sigmas) > MAX_SIGMA_CLASSES or any(
            s < 2 or s > 15 for s in sigmas):
        raise ValueError(f"rotate_plane: sigma classes {sigmas} outside "
                         f"2..15 (exp_rotation's stride2 is never 1)")
    band_off = [int(v) for v in band_off]
    return ([(s, _sigma_lo_col(s, band_off), True) for s in sigmas]
            + [(1, 0, False)])


def rotate_plane_ref(x, pk, th, g, sigmas, band_off):
    """Plain PyTorch rotation of a position-major plane.

    Args:
      x: [W, R] float32 raw pulse values.
      pk: [W, R] int32 packed markers (-1 where none).
      th, g: [W, R] float32 marker theta and gain (read only at markers).
      sigmas: the sigma classes present (static tuple within 2..15).
      band_off: band start columns (nb + 1 entries, last = W or less).
    Returns the rotated, gain-scaled plane [W, R].

    A loop over positions, vectorized over rows, in exp_rotation1's
    scalar order: slow by design, the yardstick for the kernel.
    """
    W, R = x.shape
    dev = x.device

    # 1. fill the markers forward along position
    kf = torch.empty_like(pk)
    tf = torch.empty_like(th)
    gf = torch.empty_like(g)
    kf[0], tf[0], gf[0] = pk[0], th[0], g[0]
    for i in range(1, W):
        m = pk[i] >= 0
        kf[i] = torch.where(m, pk[i], kf[i - 1])
        tf[i] = torch.where(m, th[i], tf[i - 1])
        gf[i] = torch.where(m, g[i], gf[i - 1])

    # 2. validity, segment keys, lag classes, coefficients
    pos = torch.arange(W, device=dev, dtype=kf.dtype)[:, None]
    valid = (kf >= 0) & ((pos - (kf >> 13)) < ((kf >> 4) & 0x1FF))
    key = torch.where(valid, kf, -1 - pos)
    lag = torch.where(valid, kf & 15, torch.zeros_like(kf))
    rot_on = valid & (tf > 0)
    half_pi = x.new_tensor(math.pi * 0.5)
    one, zero = x.new_ones(()), x.new_zeros(())
    cs = torch.where(rot_on, torch.cos(half_pi * tf), one)
    sn = torch.where(rot_on, torch.sin(half_pi * tf), zero)
    gm = torch.where(valid, gf, one)

    # 3. the sweeps. Where a step does not act its coefficients are set
    # to (1, 0), which leaves both values bit for bit as they were.
    buf = x.clone()
    for sg, lo, swapped in _classes(sigmas, band_off):
        sel = (lag == 1 + sg) if swapped else (lag > 0)
        c_all, s_all = (sn, cs) if swapped else (cs, sn)

        def coefs(span):
            op = (key[:-span] == key[span:]) & sel[:-span]
            return (torch.where(op, c_all[:-span], one),
                    torch.where(op, s_all[:-span], zero))

        def step(i, cc, ss):
            x1, x2 = buf[i], buf[i + sg]
            new2 = cc[i] * x2 + ss[i] * x1
            buf[i] = cc[i] * x1 - ss[i] * x2
            buf[i + sg] = new2

        if W - sg > lo:
            cc, ss = coefs(sg)
            for i in range(lo, W - sg):
                step(i, cc, ss)
        if W - 2 * sg > lo:
            cc, ss = coefs(2 * sg)
            for i in range(W - 2 * sg - 1, lo - 1, -1):
                step(i, cc, ss)

    # 4. per-leaf gain
    return buf * gm


_BOUND = False


def _rot_lib() -> ctypes.CDLL:
    global _BOUND
    L = kernels.load("rot")
    if not _BOUND:
        vp = ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int)
        L.rotate_plane_launch.restype = ctypes.c_int
        L.rotate_plane_launch.argtypes = [
            vp, vp, vp, vp,                         # x pk th g
            vp, vp, vp, vp, vp,                     # y key cs sn gm
            ctypes.c_int, ctypes.c_longlong,        # W, R
            ip, ip, ctypes.c_int, vp,               # sigmas, los, n, stream
        ]
        _BOUND = True
    return L


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"rotate_plane_cuda: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"rotate_plane_cuda: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"rotate_plane_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"rotate_plane_cuda: {name} is not contiguous")


def rotate_plane_cuda(x, pk, th, g, sigmas, band_off):
    """The rotation on the card through the hand-written kernel.

    Same arguments as rotate_plane_ref, every tensor contiguous [W, R]
    on one CUDA device (x, th, g float32; pk int32). Allocates the
    output and four scratch planes of the same size. Counts its launches
    in ``rotate_plane_cuda.launches``.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rotate_plane_cuda: x is on {dev}, not CUDA")
    if x.dim() != 2:
        raise ValueError(f"rotate_plane_cuda: x must be [W, R], got "
                         f"{tuple(x.shape)}")
    W, R = x.shape
    _check("x", x, torch.float32, (W, R), dev)
    _check("pk", pk, torch.int32, (W, R), dev)
    _check("th", th, torch.float32, (W, R), dev)
    _check("g", g, torch.float32, (W, R), dev)
    classes = _classes(sigmas, band_off)[:-1]     # the kernel adds lag 1
    y = torch.empty_like(x)
    if W and R:
        key = torch.empty_like(pk)
        cs, sn, gm = (torch.empty_like(x) for _ in range(3))
        n = len(classes)
        sg_arr = (ctypes.c_int * max(n, 1))(*[c[0] for c in classes])
        lo_arr = (ctypes.c_int * max(n, 1))(*[c[1] for c in classes])
        L = _rot_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = L.rotate_plane_launch(
                x.data_ptr(), pk.data_ptr(), th.data_ptr(), g.data_ptr(),
                y.data_ptr(), key.data_ptr(), cs.data_ptr(), sn.data_ptr(),
                gm.data_ptr(), W, R, sg_arr, lo_arr, n, stream)
        if rc != 0:
            raise RuntimeError(f"rot kernel launch failed: CUDA error {rc}")
        rotate_plane_cuda.launches += 1
    return y


rotate_plane_cuda.launches = 0


def rotate_plane(x, pk, th, g, sigmas, band_off):
    """Device dispatch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (never the plain version on a card)."""
    if x.device.type == "cuda":
        return rotate_plane_cuda(x, pk, th, g, sigmas, band_off)
    if x.device.type == "cpu":
        return rotate_plane_ref(x, pk, th, g, sigmas, band_off)
    raise ValueError(f"rotate_plane: no implementation for {x.device}")
