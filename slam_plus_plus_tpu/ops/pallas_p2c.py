"""Fused Pallas kernel (Triton route) for P2C (mono reprojection) edge terms.

The hot assembly kernel of the flagship BA workload: residual + analytic
jacobians + all Hessian/gradient block products for every observation, in
one pass — the analogue of the reference's FBS-specialized per-edge
Hessian code (reference include/slam/BA_Types.h:403 CEdgeP2C3D +
BASolverBase.h projection).

Layout: the assembler's own edge-major arrays ([E, d], no transposes).  One
program handles ``BLOCK`` edges (a power of two, as Triton requires); each
per-edge scalar is one strided column load ``ref[:, c]`` of BLOCK values,
so all math is elementwise on [BLOCK] vectors held in registers.  About 20
floats go in and 74 come out per edge.  The wrapper pads E up to a multiple
of BLOCK with zero-information edges and slices the padding off.

The generic jacfwd path computes identical values (the assembler selects
this kernel when the edge type / block sizes match and it is enabled);
equality is asserted in tests with the kernel in interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

BLOCK = 256       # edges per program
NUM_WARPS = 4

# per-edge output widths, in kernel output order
OUT_WIDTHS = (("chi2", 0), ("hdiag", 0), ("g_cam", 6), ("g_pt", 3),
              ("hcc", 36), ("hcp", 18), ("hpp", 9))


def _p2c_kernel(cam_ref, pt_ref, z_ref, info_ref,
                chi2_ref, hdiag_ref, gc_ref, gp_ref,
                hcc_ref, hcp_ref, hpp_ref):
    # unpack per-edge columns ([BLOCK] vectors)
    tx, ty, tz = cam_ref[:, 0], cam_ref[:, 1], cam_ref[:, 2]
    ax, ay, az = cam_ref[:, 3], cam_ref[:, 4], cam_ref[:, 5]
    fx, fy = cam_ref[:, 6], cam_ref[:, 7]
    cx, cy = cam_ref[:, 8], cam_ref[:, 9]
    dd = cam_ref[:, 10]
    px, py, pz = pt_ref[:, 0], pt_ref[:, 1], pt_ref[:, 2]
    z0, z1 = z_ref[:, 0], z_ref[:, 1]
    i00, i01 = info_ref[:, 0], info_ref[:, 1]
    i10, i11 = info_ref[:, 2], info_ref[:, 3]

    # Rodrigues rotation from axis-angle (Taylor-guarded)
    th2 = ax * ax + ay * ay + az * az
    th = jnp.sqrt(th2)
    small = th2 < 1e-12
    A = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / jnp.where(small, 1.0, th))
    B = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.where(small, 1.0, th2))
    r00 = 1.0 - B * (ay * ay + az * az)
    r01 = B * ax * ay - A * az
    r02 = B * ax * az + A * ay
    r10 = B * ax * ay + A * az
    r11 = 1.0 - B * (ax * ax + az * az)
    r12 = B * ay * az - A * ax
    r20 = B * ax * az - A * ay
    r21 = B * ay * az + A * ax
    r22 = 1.0 - B * (ax * ax + ay * ay)

    # p_cam = R p + t
    pcx = r00 * px + r01 * py + r02 * pz + tx
    pcy = r10 * px + r11 * py + r12 * pz + ty
    pcz = r20 * px + r21 * py + r22 * pz + tz
    safe = jnp.abs(pcz) > 1e-12
    iz = 1.0 / jnp.where(safe, pcz, 1.0)

    du = fx * pcx * iz
    dv = fy * pcy * iz
    k = dd / (0.5 * (fx + fy))
    r2 = du * du + dv * dv
    w = 1.0 + k * r2
    hx = cx + w * du
    hy = cy + w * dv
    e0 = z0 - hx
    e1 = z1 - hy

    # weighted residual: S = info @ [e0; e1]
    se0 = i00 * e0 + i01 * e1
    se1 = i10 * e0 + i11 * e1
    chi2_ref[...] = e0 * se0 + e1 * se1

    # projection chain: dh/dp_cam = M (2x2 distortion) @ P (2x3 pinhole)
    m00 = w + 2.0 * k * du * du
    m01 = 2.0 * k * du * dv
    m11 = w + 2.0 * k * dv * dv
    p00 = fx * iz
    p02 = -fx * pcx * iz * iz
    p11 = fy * iz
    p12 = -fy * pcy * iz * iz
    # Dh = [[m00*p00, m01*p11, m00*p02+m01*p12],
    #       [m01*p00, m11*p11, m01*p02+m11*p12]]
    d00 = m00 * p00
    d01 = m01 * p11
    d02 = m00 * p02 + m01 * p12
    d10 = m01 * p00
    d11 = m11 * p11
    d12 = m01 * p02 + m11 * p12

    # dr/d(delta) = -dh/d(delta); columns of J (2 rows each):
    # point: Dpc_p = R -> Jp_c = -Dh @ R[:, c]
    # cam translation: Dpc_t = R (same columns)
    # cam rotation: Dpc_w = -R [p]x  with [p]x columns:
    #   col0 = (0, pz, -py), col1 = (-pz, 0, px), col2 = (py, -px, 0)
    def dh_dot(cx_, cy_, cz_):
        return (d00 * cx_ + d01 * cy_ + d02 * cz_,
                d10 * cx_ + d11 * cy_ + d12 * cz_)

    # R columns
    Rc = ((r00, r10, r20), (r01, r11, r21), (r02, r12, r22))
    Jt = [dh_dot(*Rc[c]) for c in range(3)]          # dh/d(delta t) cols
    # R [p]x columns: R @ col_i of [p]x
    zero = 0.0 * px
    px_cols = ((zero, pz, -py), (-pz, zero, px), (py, -px, zero))
    Jw = []
    for c in range(3):
        vx, vy, vz = px_cols[c]
        rx = r00 * vx + r01 * vy + r02 * vz
        ry = r10 * vx + r11 * vy + r12 * vz
        rz = r20 * vx + r21 * vy + r22 * vz
        # Dpc_w = -R[p]x ; dh/dw = Dh @ Dpc_w = -dh_dot(R[p]x col)
        a0, a1 = dh_dot(rx, ry, rz)
        Jw.append((-a0, -a1))
    # J (dr/d.) = -(dh/d.)
    Jcam = [(-a, -b) for (a, b) in Jt + Jw]          # 6 columns, 2 rows
    Jpt = [(-a, -b) for (a, b) in Jt]                # point cols == t cols

    # g = -J^T (info r)
    for c in range(6):
        a, b = Jcam[c]
        gc_ref[:, c] = -(a * se0 + b * se1)
    for c in range(3):
        a, b = Jpt[c]
        gp_ref[:, c] = -(a * se0 + b * se1)

    # H blocks: H_ab[c1,c2] = Ja_c1^T info Jb_c2  (2-vector contraction);
    # returns the diagonal entries when JA is JB
    def hprod(JA, JB, out_ref):
        diag = []
        for c1, (a1, b1) in enumerate(JA):
            wa = i00 * a1 + i10 * b1
            wb = i01 * a1 + i11 * b1
            for c2, (a2, b2) in enumerate(JB):
                h = wa * a2 + wb * b2
                out_ref[:, c1 * len(JB) + c2] = h
                if c1 == c2:
                    diag.append(h)
        return diag

    diag = hprod(Jcam, Jcam, hcc_ref)
    hprod(Jcam, Jpt, hcp_ref)
    diag += hprod(Jpt, Jpt, hpp_ref)

    # hdiag = max diagonal over both vertex Hessians
    hd = diag[0]
    for h in diag[1:]:
        hd = jnp.maximum(hd, h)
    hdiag_ref[...] = hd


@functools.partial(jax.jit, static_argnames=("interpret",))
def p2c_edge_terms(cam, pt, z, info, interpret=False):
    """Per-edge P2C terms from edge-major inputs: cam [E, 11], pt [E, 3],
    z [E, 2], info [E, 4] (row-major 2x2).  Any E; padded internally.

    Returns (chi2 [E], hdiag [E], g_cam [E, 6], g_pt [E, 3],
             hcc [E, 36], hcp [E, 18], hpp [E, 9])."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    E = cam.shape[0]
    dt = cam.dtype
    n_blocks = max(pl.cdiv(E, BLOCK), 1)
    pad = n_blocks * BLOCK - E
    if pad:
        # zero-information padding edges; the camera pads to the first real
        # camera so the padded projections stay finite
        cam = jnp.concatenate([cam, jnp.broadcast_to(cam[:1], (pad, 11))])
        pt, z, info = (jnp.pad(x, ((0, pad), (0, 0))) for x in (pt, z, info))
    Ep = E + pad

    def spec(d):
        if d == 0:
            return pl.BlockSpec((BLOCK,), lambda i: (i,))
        return pl.BlockSpec((BLOCK, d), lambda i: (i, 0))

    outs = pl.pallas_call(
        _p2c_kernel,
        grid=(n_blocks,),
        in_specs=[spec(11), spec(3), spec(2), spec(4)],
        out_specs=[spec(d) for _n, d in OUT_WIDTHS],
        out_shape=[jax.ShapeDtypeStruct((Ep, d) if d else (Ep,), dt)
                   for _n, d in OUT_WIDTHS],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="p2c_edge_terms",
    )(cam, pt, z, info)
    return tuple(o[:E] for o in outs) if pad else tuple(outs)
