"""Device loop filters: vectorized deblocking + SAO (spec 8.7), bit-exact.

Host side precomputes per-edge-segment parameter grids (bS, beta, tc) from the
FramePlan metadata maps -- sharing the bS derivation with the golden filter --
and per-pixel SAO parameter maps.  Device side is branch-free int32 jnp over
whole planes; the horizontal deblock pass reuses the vertical kernel on the
transposed plane (the filter is 1-D across the edge).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from p265_tpu.golden.deblock import _bs
from p265_tpu.syntax.ctu import SAO_BAND, SAO_EDGE, FramePlan
from p265_tpu.tables import BETA_TABLE, TC_TABLE, chroma_qp_from_luma, clip3

# ---------------------------------------------------------------------------
# host: edge parameter grids
# ---------------------------------------------------------------------------


NO_REF = -(1 << 30)


def _bs_vec(plan: FramePlan, y4p, x4p, y4q, x4q):
    """Vectorized boundary strength (8.7.2.4) over index grids; numerically
    identical to golden.deblock._bs (the oracle's scalar form: ref-set diff,
    mv-count diff, then lane-order mv comparison at quarter-pel threshold 4)."""
    im, cbf = plan.intra_map, plan.cbf_map
    intra = im[y4p, x4p].astype(bool) | im[y4q, x4q].astype(bool)
    has_cbf = cbf[y4p, x4p].astype(bool) | cbf[y4q, x4q].astype(bool)
    mv_ne = np.zeros(np.shape(y4p), bool)
    if plan.mv_map is not None:
        mv, rf = plan.mv_map, plan.ref_map
        rp = rf[y4p, x4p].astype(np.int64)   # [..., 2]
        rq = rf[y4q, x4q].astype(np.int64)
        up0, up1 = rp[..., 0] != NO_REF, rp[..., 1] != NO_REF
        uq0, uq1 = rq[..., 0] != NO_REF, rq[..., 1] != NO_REF
        cnt_p = up0.astype(np.int32) + up1.astype(np.int32)
        cnt_q = uq0.astype(np.int32) + uq1.astype(np.int32)
        big = np.int64(1) << 60

        def ref_set(r, u0, u1):      # set as sorted (lo, hi) with dedupe
            a = np.where(u0, r[..., 0], big)
            b = np.where(u1, r[..., 1], big)
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            return lo, np.where(lo == hi, big, hi)

        lp, hp = ref_set(rp, up0, up1)
        lq, hq = ref_set(rq, uq0, uq1)
        set_ne = (lp != lq) | (hp != hq)

        mvp = mv[y4p, x4p]           # [..., 2, 2]
        mvq = mv[y4q, x4q]
        first_p = np.where(up0[..., None], mvp[..., 0, :], mvp[..., 1, :])
        first_q = np.where(uq0[..., None], mvq[..., 0, :], mvq[..., 1, :])

        def ge4(a, b):
            return (np.abs(a[..., 0] - b[..., 0]) >= 4)                 | (np.abs(a[..., 1] - b[..., 1]) >= 4)

        both2 = (cnt_p == 2) & (cnt_q == 2)
        mv_ne = (set_ne | (cnt_p != cnt_q) | ge4(first_p, first_q)
                 | (both2 & ge4(mvp[..., 1, :], mvq[..., 1, :])))
    return np.where(intra, 2,
                    np.where(has_cbf | mv_ne, 1, 0)).astype(np.int32)


def luma_edge_params(plan: FramePlan, vertical: bool):
    """-> (bs, beta, tc) int32 arrays [n_seg, n_edges] in the orientation the
    device kernel consumes (transposed layout for horizontal edges)."""
    sps, sh = plan.sps, plan.sh
    w, h = sps.pic_width, sps.pic_height
    ef, qp = plan.edge_flags, plan.qp_map
    boff, toff = sh.beta_offset_div2 << 1, sh.tc_offset_div2 << 1
    n_s = h // 4 if vertical else w // 4
    edges = np.arange(8, w if vertical else h, 8)
    n_e = len(edges)
    if n_e == 0:
        z = np.zeros((n_s, 0), np.int32)
        return z, z.copy(), z.copy()
    s4 = np.arange(n_s)[:, None]            # segment index (4-sample rows)
    e4 = (edges >> 2)[None, :]
    if vertical:
        on = (ef[s4, e4] & 1).astype(bool)
        bs = _bs_vec(plan, s4, e4 - 1, s4, e4)
        qpl = (qp[s4, e4 - 1].astype(np.int32)
               + qp[s4, e4].astype(np.int32) + 1) >> 1
    else:
        on = (ef[e4, s4] & 2).astype(bool)
        bs = _bs_vec(plan, e4 - 1, s4, e4, s4)
        qpl = (qp[e4 - 1, s4].astype(np.int32)
               + qp[e4, s4].astype(np.int32) + 1) >> 1
    bs = np.where(on, bs, 0)
    beta = np.where(bs > 0,
                    BETA_TABLE[np.clip(qpl + boff, 0, 51)], 0).astype(np.int32)
    tc = np.where(bs > 0,
                  TC_TABLE[np.clip(qpl + 2 * (bs - 1) + toff, 0, 53)],
                  0).astype(np.int32)
    return bs, beta, tc


def chroma_edge_params(plan: FramePlan, vertical: bool):
    """-> (tc_cb, tc_cr) [n_seg, n_edges] in chroma coords; 0 = no filter."""
    sps, sh = plan.sps, plan.sh
    w, h = sps.pic_width, sps.pic_height
    ef, qp = plan.edge_flags, plan.qp_map
    toff = sh.tc_offset_div2 << 1
    edges = np.arange(16, w if vertical else h, 16)
    n_s = (h if vertical else w) // 8
    if len(edges) == 0:
        z = np.zeros((n_s, 0), np.int32)
        return [z, z.copy()]
    s4 = (np.arange(n_s) * 2)[:, None]      # 8-sample rows in 4x4 units
    e4 = (edges >> 2)[None, :]
    if vertical:
        on = (ef[s4, e4] & 1).astype(bool)
        bs = _bs_vec(plan, s4, e4 - 1, s4, e4)
        qpl = (qp[s4, e4 - 1].astype(np.int32)
               + qp[s4, e4].astype(np.int32) + 1) >> 1
    else:
        on = (ef[e4, s4] & 2).astype(bool)
        bs = _bs_vec(plan, e4 - 1, s4, e4, s4)
        qpl = (qp[e4 - 1, s4].astype(np.int32)
               + qp[e4, s4].astype(np.int32) + 1) >> 1
    strong = on & (bs >= 2)
    qpc_lut = np.array([chroma_qp_from_luma(q) for q in range(58)], np.int32)
    tcs = []
    for c_off in (plan.pps.cb_qp_offset, plan.pps.cr_qp_offset):
        qpc = qpc_lut[np.clip(qpl + c_off, 0, 57)]
        tcs.append(np.where(strong,
                            TC_TABLE[np.clip(qpc + 2 + toff, 0, 53)],
                            0).astype(np.int32))
    return tcs


# ---------------------------------------------------------------------------
# device: deblock
# ---------------------------------------------------------------------------


@jax.jit
def _deblock_luma_vertical(plane, bs, beta, tc):
    """plane [H, W]; bs/beta/tc [H//4, n_e]; edges at x = 8*(k+1)."""
    H, W = plane.shape
    n_e = bs.shape[1]
    cols = 8 * (jnp.arange(n_e) + 1)
    p = [plane[:, cols - 1 - i] for i in range(4)]   # [H, n_e] each
    q = [plane[:, cols + i] for i in range(4)]

    def seg(v):  # [H, n_e] -> [H//4, 4, n_e]
        return v.reshape(H // 4, 4, n_e)

    sp = [seg(v) for v in p]
    sq = [seg(v) for v in q]
    dp0 = jnp.abs(sp[2][:, 0] - 2 * sp[1][:, 0] + sp[0][:, 0])
    dp3 = jnp.abs(sp[2][:, 3] - 2 * sp[1][:, 3] + sp[0][:, 3])
    dq0 = jnp.abs(sq[2][:, 0] - 2 * sq[1][:, 0] + sq[0][:, 0])
    dq3 = jnp.abs(sq[2][:, 3] - 2 * sq[1][:, 3] + sq[0][:, 3])
    d = dp0 + dp3 + dq0 + dq3
    filt = (bs > 0) & (d < beta)

    def strong_line(ln):
        dpl = dp0 if ln == 0 else dp3
        dql = dq0 if ln == 0 else dq3
        return ((2 * (dpl + dql) < (beta >> 2))
                & (jnp.abs(sp[3][:, ln] - sp[0][:, ln])
                   + jnp.abs(sq[0][:, ln] - sq[3][:, ln]) < (beta >> 3))
                & (jnp.abs(sp[0][:, ln] - sq[0][:, ln]) < ((5 * tc + 1) >> 1)))

    strong = strong_line(0) & strong_line(3)         # [H//4, n_e]
    dep1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    deq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    def up(m):  # segment mask -> per-line [H, n_e]
        return jnp.repeat(m, 4, axis=0)

    tcl = up(tc)
    p0, p1, p2, p3 = p
    q0, q1, q2, q3 = q
    # strong
    sp0 = jnp.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   p0 - 2 * tcl, p0 + 2 * tcl)
    sp1 = jnp.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tcl, p1 + 2 * tcl)
    sp2 = jnp.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                   p2 - 2 * tcl, p2 + 2 * tcl)
    sq0 = jnp.clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                   q0 - 2 * tcl, q0 + 2 * tcl)
    sq1 = jnp.clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tcl, q1 + 2 * tcl)
    sq2 = jnp.clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                   q2 - 2 * tcl, q2 + 2 * tcl)
    # weak
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wok = jnp.abs(delta) < tcl * 10
    dlt = jnp.clip(delta, -tcl, tcl)
    wp0 = jnp.clip(p0 + dlt, 0, 255)
    wq0 = jnp.clip(q0 - dlt, 0, 255)
    dp_ = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                   -(tcl >> 1), tcl >> 1)
    wp1 = jnp.clip(p1 + dp_, 0, 255)
    dq_ = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                   -(tcl >> 1), tcl >> 1)
    wq1 = jnp.clip(q1 + dq_, 0, 255)

    filt_l = up(filt)
    strong_l = up(filt & strong)
    weak_l = filt_l & ~strong_l & wok
    weakp1 = weak_l & up(dep1)
    weakq1 = weak_l & up(deq1)

    np0 = jnp.where(strong_l, sp0, jnp.where(weak_l, wp0, p0))
    np1 = jnp.where(strong_l, sp1, jnp.where(weakp1, wp1, p1))
    np2 = jnp.where(strong_l, sp2, p2)
    nq0 = jnp.where(strong_l, sq0, jnp.where(weak_l, wq0, q0))
    nq1 = jnp.where(strong_l, sq1, jnp.where(weakq1, wq1, q1))
    nq2 = jnp.where(strong_l, sq2, q2)

    plane = plane.at[:, cols - 1].set(np0)
    plane = plane.at[:, cols - 2].set(np1)
    plane = plane.at[:, cols - 3].set(np2)
    plane = plane.at[:, cols + 0].set(nq0)
    plane = plane.at[:, cols + 1].set(nq1)
    plane = plane.at[:, cols + 2].set(nq2)
    return plane


@jax.jit
def _deblock_chroma_vertical(plane, tc):
    """plane [Hc, Wc]; tc [Hc//4, n_e]; edges at x = 8*(k+1) chroma samples."""
    Hc, Wc = plane.shape
    n_e = tc.shape[1]
    cols = 8 * (jnp.arange(n_e) + 1)
    p1 = plane[:, cols - 2]
    p0 = plane[:, cols - 1]
    q0 = plane[:, cols + 0]
    q1 = plane[:, cols + 1]
    tcl = jnp.repeat(tc, 4, axis=0)
    delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tcl, tcl)
    on = tcl > 0
    np0 = jnp.where(on, jnp.clip(p0 + delta, 0, 255), p0)
    nq0 = jnp.where(on, jnp.clip(q0 - delta, 0, 255), q0)
    plane = plane.at[:, cols - 1].set(np0)
    plane = plane.at[:, cols + 0].set(nq0)
    return plane


def deblock_tpu(plan: FramePlan, planes: list) -> list:
    y, cb, cr = (jnp.asarray(p) for p in planes)
    # vertical then horizontal (horizontal = vertical kernel on transpose)
    bs, beta, tc = luma_edge_params(plan, vertical=True)
    if bs.size:
        y = _deblock_luma_vertical(y, jnp.asarray(bs), jnp.asarray(beta),
                                   jnp.asarray(tc))
    tcb, tcr = chroma_edge_params(plan, vertical=True)
    if tcb.size:
        cb = _deblock_chroma_vertical(cb, jnp.asarray(tcb))
        cr = _deblock_chroma_vertical(cr, jnp.asarray(tcr))
    bs, beta, tc = luma_edge_params(plan, vertical=False)
    if bs.size:
        y = _deblock_luma_vertical(y.T, jnp.asarray(bs), jnp.asarray(beta),
                                   jnp.asarray(tc)).T
    tcb, tcr = chroma_edge_params(plan, vertical=False)
    if tcb.size:
        cb = _deblock_chroma_vertical(cb.T, jnp.asarray(tcb)).T
        cr = _deblock_chroma_vertical(cr.T, jnp.asarray(tcr)).T
    return [y, cb, cr]


# ---------------------------------------------------------------------------
# SAO
# ---------------------------------------------------------------------------

_EO = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))


def _sao_maps(plan: FramePlan, c: int):
    """Per-CTU parameter grids (tiny); expansion to pixels happens on device."""
    sps = plan.sps
    nx, ny = sps.pic_width_ctbs, sps.pic_height_ctbs
    ty = np.zeros((ny, nx), np.int32)
    cls = np.zeros((ny, nx), np.int32)
    offs = np.zeros((4, ny, nx), np.int32)
    for a, rec in enumerate(plan.sao):
        iy, ix = divmod(a, nx)
        ty[iy, ix] = rec.type[c]
        cls[iy, ix] = rec.cls[c]
        for i in range(4):
            offs[i, iy, ix] = rec.offsets[c][i]
    return ty, cls, offs


@functools.partial(jax.jit, static_argnames=("ctb",))
def _sao_apply(src, ty_g, cls_g, offs_g, ctb: int):
    H, W = src.shape

    def expand(m):  # [ny, nx] -> [H, W] on device
        e = jnp.repeat(jnp.repeat(m, ctb, axis=0), ctb, axis=1)
        return e[:H, :W]

    ty = expand(ty_g)
    cls = expand(cls_g)
    o0, o1, o2, o3 = (expand(offs_g[i]) for i in range(4))
    v = src
    # band
    band = v >> 3
    rel = (band - cls) & 31
    d_band = jnp.where(rel == 0, o0, 0) + jnp.where(rel == 1, o1, 0) \
        + jnp.where(rel == 2, o2, 0) + jnp.where(rel == 3, o3, 0)
    # edge: compute for all 4 classes, select by cls
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    d_edges = []
    for (dy0, dx0, dy1, dx1) in _EO:
        n0 = jnp.roll(jnp.roll(v, -dy0, 0), -dx0, 1)
        n1 = jnp.roll(jnp.roll(v, -dy1, 0), -dx1, 1)
        valid = ((yy + dy0 >= 0) & (yy + dy0 < H) & (xx + dx0 >= 0)
                 & (xx + dx0 < W) & (yy + dy1 >= 0) & (yy + dy1 < H)
                 & (xx + dx1 >= 0) & (xx + dx1 < W))
        e = jnp.sign(v - n0) + jnp.sign(v - n1)
        d = jnp.where(e == -2, o0, 0) + jnp.where(e == -1, o1, 0) \
            + jnp.where(e == 1, o2, 0) + jnp.where(e == 2, o3, 0)
        d_edges.append(jnp.where(valid, d, 0))
    d_edge = jnp.where(cls == 0, d_edges[0],
                       jnp.where(cls == 1, d_edges[1],
                                 jnp.where(cls == 2, d_edges[2], d_edges[3])))
    delta = jnp.where(ty == SAO_BAND, d_band,
                      jnp.where(ty == SAO_EDGE, d_edge, 0))
    return jnp.clip(v + delta, 0, 255)


def sao_tpu(plan: FramePlan, planes: list) -> list:
    sh = plan.sh
    outs = []
    for c in range(3):
        enabled = sh.sao_luma if c == 0 else sh.sao_chroma
        if not enabled:
            outs.append(planes[c])
            continue
        ty, cls, offs = _sao_maps(plan, c)
        ctb = plan.sps.ctb_size if c == 0 else plan.sps.ctb_size >> 1
        outs.append(_sao_apply(jnp.asarray(planes[c]), jnp.asarray(ty),
                               jnp.asarray(cls), jnp.asarray(offs), ctb))
    return outs


# batched variants: one dispatch filters F same-shape frames (leading axis)
_deblock_luma_v_b = jax.jit(jax.vmap(_deblock_luma_vertical.__wrapped__))
_deblock_chroma_v_b = jax.jit(jax.vmap(_deblock_chroma_vertical.__wrapped__))


@functools.partial(jax.jit, static_argnames=("ctb",))
def _sao_apply_b(src, ty_g, cls_g, offs_g, ctb: int):
    return jax.vmap(_sao_apply.__wrapped__,
                    in_axes=(0, 0, 0, 0, None))(src, ty_g, cls_g, offs_g, ctb)


def loop_filters_tpu_frames(plans: list, planes_list: list) -> list:
    """Loop filters for F same-resolution frames in batched dispatches:
    per-pass vmapped kernels instead of per-frame call chains (the host
    edge-parameter grids are built per frame, vectorized numpy).  Accepts
    and returns DEVICE arrays; no host round trips inside."""
    from p265_tpu.golden.decoder import bypass_pixel_masks
    F = len(plans)
    if F == 1:
        return [loop_filters_tpu(plans[0], planes_list[0])]
    comp = [jnp.stack([jnp.asarray(pl[c]) for pl in planes_list])
            for c in range(3)]
    sh0 = plans[0].sh
    if any(p.sh.deblocking_filter_disabled != sh0.deblocking_filter_disabled
           or p.sh.sao_luma != sh0.sao_luma
           or p.sh.sao_chroma != sh0.sao_chroma for p in plans):
        # heterogeneous filter flags: per-frame path
        return [loop_filters_tpu(p, pl) for p, pl in zip(plans, planes_list)]
    if not sh0.deblocking_filter_disabled:
        for vertical in (True, False):
            lp = [luma_edge_params(p, vertical) for p in plans]
            bs = jnp.asarray(np.stack([x[0] for x in lp]))
            beta = jnp.asarray(np.stack([x[1] for x in lp]))
            tc = jnp.asarray(np.stack([x[2] for x in lp]))
            cp = [chroma_edge_params(p, vertical) for p in plans]
            tcb = jnp.asarray(np.stack([x[0] for x in cp]))
            tcr = jnp.asarray(np.stack([x[1] for x in cp]))
            if not vertical:
                comp = [c.transpose(0, 2, 1) for c in comp]
            if bs.shape[2]:
                comp[0] = _deblock_luma_v_b(comp[0], bs, beta, tc)
            if tcb.shape[2]:
                comp[1] = _deblock_chroma_v_b(comp[1], tcb)
                comp[2] = _deblock_chroma_v_b(comp[2], tcr)
            if not vertical:
                comp = [c.transpose(0, 2, 1) for c in comp]
    for c in range(3):
        enabled = sh0.sao_luma if c == 0 else sh0.sao_chroma
        if not (plans[0].sps.sao_enabled and enabled):
            continue
        maps = [_sao_maps(p, c) for p in plans]
        ty = jnp.asarray(np.stack([m[0] for m in maps]))
        cls = jnp.asarray(np.stack([m[1] for m in maps]))
        offs = jnp.asarray(np.stack([m[2] for m in maps]))
        ctb = plans[0].sps.ctb_size if c == 0 else plans[0].sps.ctb_size >> 1
        comp[c] = _sao_apply_b(comp[c], ty, cls, offs, ctb)
    outs = []
    for f, plan in enumerate(plans):
        res = [comp[c][f] for c in range(3)]
        masks = bypass_pixel_masks(plan)
        if masks:
            res = [jnp.where(jnp.asarray(m), jnp.asarray(planes_list[f][c]),
                             r)
                   for c, (m, r) in enumerate(zip(masks, res))]
        outs.append(res)
    return outs


def loop_filters_tpu(plan: FramePlan, planes: list) -> list:
    from p265_tpu.golden.decoder import bypass_pixel_masks
    masks = bypass_pixel_masks(plan)
    orig = [np.asarray(p).copy() for p in planes] if masks else None
    out = [jnp.asarray(p) for p in planes]
    if not plan.sh.deblocking_filter_disabled:
        out = deblock_tpu(plan, out)
    if plan.sps.sao_enabled and (plan.sh.sao_luma or plan.sh.sao_chroma):
        out = sao_tpu(plan, out)
    res = [np.asarray(p) for p in out]
    if masks:
        res = [np.where(m, o, p) for m, o, p in zip(masks, orig, res)]
    return res
