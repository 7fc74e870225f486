"""CELT spreading rotation over the raw-iy leaf plane: plain versions + CUDA
kernel.

The decoder's exp_rotation (reference: celt/vq.c:77, decode direction)
spreads each PVQ leaf with Givens sweeps: per sub-segment a forward and
a backward sweep at stride sigma with swapped coefficients, then both at
lag 1, then the per-leaf gain. Here it runs over the whole dense plane
at once. Sparse markers say where sub-segments start: ``pk`` packs
``column << 13 | sub-segment length << 4 | lag`` (lag = 1 + sigma for a
rotating sub-segment, 1 otherwise; -1 = no marker), ``th`` the rotation
angle parameter theta (0 = no rotation) and ``g`` the leaf's final gain.

Two layouts. The entry ``rotate_plane`` and the kernel take the planes
row-major, as the device replay's heap scatter builds them
(ops/celt_replay.py): values ``[R, nmax]`` with rows ``c * F + f`` and
the W = 100 << LM band positions first along the fast axis, markers
``[R, W]``; columns W .. nmax pass through. The plain version
``rotate_plane_ref`` takes position-major ``[W, R]`` planes, the layout
of the reference package's kernel that the tests hold it against.

``rotate_plane`` dispatches on the tensor's device: a CPU tensor goes,
transposed, to the plain PyTorch version ``rotate_plane_ref``; a CUDA
tensor goes to the hand-written kernel (``csrc/rot.cu``) through
``rotate_plane_cuda``, or the call raises. ``rotate_rows_segments_ref``
states the kernel's own algorithm (compact markers per row, effective
length, exp_rotation1 per sub-segment) in plain PyTorch.
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


def _exp_rotation1(s, L, stride, c, sn):
    """vq.c exp_rotation1 on the first L entries of the 1-D float32
    tensor s, in place and in its scalar order."""
    for i in list(range(L - stride)) + list(range(L - 2 * stride - 1, -1, -1)):
        x1, x2 = s[i].clone(), s[i + stride].clone()
        s[i + stride] = c * x2 + sn * x1
        s[i] = c * x1 - sn * x2


def rotate_rows_segments_ref(x, pk, th, g, sigmas):
    """Plain PyTorch rotation of a row-major plane, sub-segment by
    sub-segment: the algorithm of the CUDA kernel.

    Args:
      x: [R, nmax] float32 raw pulse values.
      pk: [R, W] int32 packed markers (-1 where none), W <= nmax.
      th, g: [R, W] float32 marker theta and gain (read only at markers).
      sigmas: the sigma classes that rotate at their stride.
    Returns the rotated, gain-scaled plane [R, nmax].

    Per row: the markers in position order; each marker at position p
    owns positions p .. p + L - 1 with L = min(column + length - p, next
    marker's position - p, W - p), so a later marker cuts an earlier
    sub-segment short; on them exp_rotation1 at stride sigma with (c, s)
    swapped, exp_rotation1 at stride 1, then the gain. Positions in no
    sub-segment pass through. Python loops over rows and sub-segments:
    for small sizes only.
    """
    W = pk.shape[1]
    y = x.clone()
    half_pi = x.new_tensor(math.pi * 0.5)
    one, zero = x.new_ones(()), x.new_zeros(())
    allowed = {int(s) for s in sigmas}
    for r in range(x.shape[0]):
        cols = torch.nonzero(pk[r] >= 0).flatten().tolist()
        for p, nxt in zip(cols, cols[1:] + [W]):
            key = int(pk[r, p])
            L = min(max((key >> 13) + ((key >> 4) & 0x1FF) - p, 0), nxt - p)
            if L <= 0:
                continue
            s = y[r, p : p + L]
            lag = key & 15
            on = bool(th[r, p] > 0)
            cs = torch.cos(half_pi * th[r, p]) if on else one
            sn = torch.sin(half_pi * th[r, p]) if on else zero
            if lag - 1 in allowed:
                _exp_rotation1(s, L, lag - 1, sn, cs)
            if lag > 0 and on:
                _exp_rotation1(s, L, 1, cs, sn)
            s *= g[r, p]
    return y


_BOUND = False


def _rot_lib() -> ctypes.CDLL:
    global _BOUND
    L = kernels.load("rot")
    if not _BOUND:
        vp = ctypes.c_void_p
        L.rotate_plane_launch.restype = ctypes.c_int
        L.rotate_plane_launch.argtypes = [
            vp, ctypes.c_longlong, vp, vp, vp, vp,  # x, stride, pk th g y
            ctypes.c_int, ctypes.c_int,             # W, nmax
            ctypes.c_longlong, ctypes.c_uint, vp,   # R, sigma mask, stream
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

    Row-major planes on one CUDA device: x float32 [R, nmax], unit
    stride along positions, rows a multiple of 4 floats apart and 16-byte
    aligned; pk int32 and th, g float32 contiguous [R, W] with W <= nmax,
    W and nmax multiples of 4. Allocates the output [R, nmax] and nothing
    else. Counts its launches in ``rotate_plane_cuda.launches``.

    One difference from rotate_plane_ref: that starts a sigma class's
    sweeps at the first column the class can occur in; the kernel (like
    rotate_rows_segments_ref) does not look, since no marker of a real
    trace lies before that column.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rotate_plane_cuda: x is on {dev}, not CUDA")
    if x.dim() != 2 or pk.dim() != 2:
        raise ValueError(f"rotate_plane_cuda: x must be [R, nmax] and pk "
                         f"[R, W], got {tuple(x.shape)}, {tuple(pk.shape)}")
    R, nmax = x.shape
    W = pk.shape[1]
    if x.dtype != torch.float32:
        raise TypeError(f"rotate_plane_cuda: x is {x.dtype}, expected "
                        f"torch.float32")
    _check("pk", pk, torch.int32, (R, W), dev)
    _check("th", th, torch.float32, (R, W), dev)
    _check("g", g, torch.float32, (R, W), dev)
    classes = _classes(sigmas, band_off)[:-1]     # the kernel adds lag 1
    y = torch.empty((R, nmax), dtype=torch.float32, device=dev)
    if W and R:
        stride = x.stride(0) if R > 1 else nmax
        if (x.stride(1) != 1 or stride < nmax or stride % 4 or nmax % 4
                or W % 4 or W > nmax or W > 4096 or x.data_ptr() % 16
                or pk.data_ptr() % 16):
            raise ValueError(
                f"rotate_plane_cuda: x {tuple(x.shape)} with strides "
                f"{x.stride()} and W = {W}: the kernel takes unit-stride "
                f"16-byte aligned rows, W and nmax multiples of 4, "
                f"W <= min(nmax, 4096)")
        mask = 0
        for sg, _lo, _swapped in classes:
            mask |= 1 << sg
        L = _rot_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = L.rotate_plane_launch(
                x.data_ptr(), stride, pk.data_ptr(), th.data_ptr(),
                g.data_ptr(), y.data_ptr(), W, nmax, R, mask, stream)
        if rc != 0:
            raise RuntimeError(f"rot kernel launch failed: CUDA error {rc}")
        kernels.note_launch(rotate_plane_cuda, x, pk, th, g, y)
    else:
        y.copy_(x)
    return y


rotate_plane_cuda.launches = 0


def rotate_plane(x, pk, th, g, sigmas, band_off):
    """Rotation of a row-major plane (x [R, nmax]; pk, th, g [R, W];
    returns [R, nmax], columns W .. nmax passed through). Device
    dispatch: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (never the plain version on a card)."""
    if x.device.type == "cuda":
        return rotate_plane_cuda(x, pk, th, g, sigmas, band_off)
    if x.device.type == "cpu":
        W = pk.shape[1]
        out = rotate_plane_ref(
            x[:, :W].t().contiguous(), pk.t().contiguous(),
            th.t().contiguous(), g.t().contiguous(), sigmas, band_off)
        return torch.cat([out.t(), x[:, W:]], dim=1)
    raise ValueError(f"rotate_plane: no implementation for {x.device}")
