"""Dense dual-radius photon query: for each point, the flux and count of
the photons within its radius r and within its cap radius, each photon
weighted by 1 - |n . unit(delta)| (photon_mapper.rs:77-79, 102-114).

The port of ``raytracer_tpu/ops/pallas_photon.py::_query_kernel`` (reached
through ``_call_query``/``query_photons``). The CUDA kernel lives in
``csrc/photon_query.cu``; ``query_photons_plain`` below is the same
function in plain PyTorch. The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Photons are packed as in the JAX package (``_pack_photons``): component
planes (3, P) f32 with invalid photons at ``BIG``, a (6, P) bf16 payload
(power, normal), and per-chunk AABBs over CHUNK consecutive photons. The
kernel and the plain version cull the same way: a chunk takes part only if
the squared gap between its AABB and the points' AABB is within the
largest r^2 or cap^2 of those points. Every quantity of that test is
rounded as the per-pair distance is, so the cull drops no photon in reach
and both versions count the same photons, bit for bit.

No TPU mechanism carries over: no cull bit words, no 384k-photon slabs, no
bf16 flux matmul. The sums are kept in float32 from float32 weights, which
is more exact than the TPU kernel's bf16 product (its ~0.4% rounding is the
JAX tests' 2e-2 band).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer_tpu_torch.kernels import build
from raytracer_tpu_torch.ops.photon_grid import QueryResult

TILE = 256      # points per kernel block
CHUNK = 1024    # photons per cull chunk (staged whole into shared memory)
BIG = 3.0e38
# plain version: points per cull block, and at most this many (point,
# photon) pairs per piece
PLAIN_POINTS = 2048
PLAIN_PAIRS = 1 << 24

# Kernel launches made by ``query_planes`` on CUDA tensors (see
# ``fused_bounce.LAUNCHES``).
LAUNCHES = 0


class PhotonPlanes(NamedTuple):
    """Photons packed for the query (``_pack_photons``)."""
    posf: torch.Tensor     # (3, Ppad) f32, invalid and padding at BIG
    payload: torch.Tensor  # (6, Ppad) bf16: power rgb, normal xyz
    cull: torch.Tensor     # (6, Ppad / CHUNK) f32: AABB lo xyz, hi xyz
    n_live: torch.Tensor   # (1,) int32 on the device: one past the last
    #                        valid photon (the valid count for build_grid's
    #                        valid-first order); chunks past it are not read


def _pack_photons(pos, power, norm, valid) -> PhotonPlanes:
    """Component planes and per-chunk AABBs. ``pos``/``power``/``norm``
    (P, 3), ``valid`` (P,) bool. An all-invalid chunk gets an inverted AABB
    (lo = BIG, hi = -BIG) and never passes the cull."""
    p = pos.shape[0]
    p_pad = max(CHUNK, -(-p // CHUNK) * CHUNK)
    pad = p_pad - p
    dev = pos.device
    f32 = torch.float32
    posx = torch.where(valid[:, None], pos.to(f32), BIG)
    pw, nm = power, norm
    if pad:
        posx = torch.cat([posx, torch.full((pad, 3), BIG, device=dev)])
        pw = torch.cat([pw, torch.zeros((pad, 3), dtype=pw.dtype,
                                        device=dev)])
        nm = torch.cat([nm, torch.zeros((pad, 3), dtype=nm.dtype,
                                        device=dev)])
    posf = posx.T.contiguous()
    payload = torch.cat([pw.T, nm.T], 0).to(torch.bfloat16).contiguous()
    pc = posx.reshape(p_pad // CHUNK, CHUNK, 3)
    live = pc < BIG
    lo = torch.where(live, pc, BIG).amin(1).T
    hi = torch.where(live, pc, -BIG).amax(1).T
    cull = torch.cat([lo, hi], 0).contiguous()
    idx = torch.arange(1, p + 1, dtype=torch.int32, device=dev)
    n_live = torch.where(valid, idx, 0).amax().reshape(1) if p else \
        torch.zeros((1,), dtype=torch.int32, device=dev)
    return PhotonPlanes(posf, payload, cull, n_live.to(torch.int32))


# --------------------------------------------------------------- plain

def _gap2(lo, hi, clo, chi):
    """Squared distance between the box [lo, hi] (3,) and each chunk box
    [clo, chi] (3, K), rounded in the per-pair order (x + y) + z."""
    g = torch.clamp(torch.maximum(clo - hi[:, None], lo[:, None] - chi),
                    min=0.0)
    g2 = g * g
    return (g2[0] + g2[1]) + g2[2]


def query_photons_plain(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    """The query in plain PyTorch (any device). ``points`` (N, 3) f32,
    ``r2``/``cap2`` (N,) f32. Points go in blocks of PLAIN_POINTS, each
    against the photons of the chunks that pass the cull for the block.
    Float32 matmuls must run in full precision (PyTorch's default)."""
    n = points.shape[0]
    dev = points.device
    out = torch.zeros((n, 8), device=dev)
    k_live = -(-int(planes.n_live[0]) // CHUNK)
    if n == 0 or k_live == 0:
        return _result(out)
    clo, chi = planes.cull[0:3, :k_live], planes.cull[3:6, :k_live]
    lanes = torch.arange(CHUNK, device=dev)
    for a in range(0, n, PLAIN_POINTS):
        p = points[a:a + PLAIN_POINTS]
        rr, cc = r2[a:a + PLAIN_POINTS], cap2[a:a + PLAIN_POINTS]
        reach2 = torch.maximum(rr, cc).amax()
        near = _gap2(p.amin(0), p.amax(0), clo, chi) <= reach2
        sel = (near.nonzero()[:, 0, None] * CHUNK + lanes).reshape(-1)
        px, py, pz = (p[:, c, None] for c in range(3))
        step = max(CHUNK, PLAIN_PAIRS // p.shape[0] // CHUNK * CHUNK)
        acc = out[a:a + PLAIN_POINTS]
        for b in range(0, sel.shape[0], step):
            j = sel[b:b + step]
            dx = planes.posf[0, j] - px
            dy = planes.posf[1, j] - py
            dz = planes.posf[2, j] - pz
            d2 = (dx * dx + dy * dy) + dz * dz
            in_r = d2 <= rr[:, None]
            in_c = d2 <= cc[:, None]
            pay = planes.payload[:, j].to(torch.float32)
            nd = pay[3] * dx + pay[4] * dy + pay[5] * dz
            s = 1.0 - nd.abs() * torch.rsqrt(torch.clamp(d2, min=1e-20))
            pw = pay[0:3].T
            acc[:, 0:3] += torch.where(in_r, s, 0.0) @ pw
            acc[:, 3] += in_r.sum(1)
            acc[:, 4:7] += torch.where(in_c, s, 0.0) @ pw
            acc[:, 7] += in_c.sum(1)
    return _result(out)


def _result(out) -> QueryResult:
    return QueryResult(flux_r=out[:, 0:3], count_r=out[:, 3],
                       flux_cap=out[:, 4:7], count_cap=out[:, 7])


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I,            # points r2 cap2 n
             _P, _P, _P, _I, _P,        # posf payload cull n_chunks n_live
             _P, _P]                    # out stream


def _check(name, x, dev, dtype, shape):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"photon query: {name} must be {dtype} {shape} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"photon query: {name} must be contiguous")


def _query_cuda(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    global LAUNCHES
    dev = points.device
    n = points.shape[0]
    p_pad = planes.posf.shape[1]
    k = p_pad // CHUNK
    f32 = torch.float32
    _check("points", points, dev, f32, (n, 3))
    _check("r2", r2, dev, f32, (n,))
    _check("cap2", cap2, dev, f32, (n,))
    _check("posf", planes.posf, dev, f32, (3, p_pad))
    _check("payload", planes.payload, dev, torch.bfloat16, (6, p_pad))
    _check("cull", planes.cull, dev, f32, (6, k))
    _check("n_live", planes.n_live, dev, torch.int32, (1,))
    if p_pad != k * CHUNK:
        raise ValueError(f"photon query: {p_pad} photons is not a whole "
                         f"number of {CHUNK}-photon chunks")
    out = torch.empty((n, 8), dtype=f32, device=dev)
    lib = build.bind("photon_query", "rt_photon_query", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_photon_query(
            points.data_ptr(), r2.data_ptr(), cap2.data_ptr(), n,
            planes.posf.data_ptr(), planes.payload.data_ptr(),
            planes.cull.data_ptr(), k, planes.n_live.data_ptr(),
            out.data_ptr(), stream)
    build.check_launch(lib, rc, "photon query kernel")
    LAUNCHES += 1
    return _result(out)


def query_planes(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    """Query packed photons. ``points`` (N, 3) f32, ``r2``/``cap2`` (N,)
    f32 squared radii. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if points.device.type == "cpu":
        return query_photons_plain(planes, points, r2, cap2)
    if points.device.type != "cuda":
        raise NotImplementedError(
            f"photon query: no kernel for {points.device}")
    return _query_cuda(planes, points, r2, cap2)


def query_photons(pos, power, norm, valid, points, radius,
                  cap_radius) -> QueryResult:
    """Dense dual-radius photon query, the JAX ``query_photons``
    interface: ``pos/power/norm`` (P, 3) photons with a (P,) validity
    mask, ``points`` (N, 3), ``radius`` and ``cap_radius`` scalars or (N,).
    Any photon order is correct; build_grid's cell-sorted, valid-first
    order makes the cull effective."""
    n = points.shape[0]
    dev = points.device

    def per_point(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.expand(n).contiguous() if x.dim() == 0 else x

    r, cap = per_point(radius), per_point(cap_radius)
    planes = _pack_photons(pos, power, norm, valid)
    return query_planes(planes, points.to(torch.float32).contiguous(),
                        r * r, cap * cap)
