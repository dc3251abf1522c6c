"""Device motion compensation: batched 8-tap luma / 4-tap chroma interpolation
(spec 8.5.4), bit-exact vs golden/inter.py.

Inter PUs are split on the host into fixed-size aligned blocks; the device
kernel gathers edge-clamped reference windows (indices computed on device
from integer MV parts), applies the separable filters as stacked shifted
slices (integer exact), combines uni/bi/weighted prediction, and scatters
into the prediction planes consumed by the wavefront executor.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from p265_tpu.golden.mv import NO_REF
from p265_tpu.tables import CHROMA_FILTER, LUMA_FILTER

BIT_DEPTH = 8
BL = 4   # luma MC block size (minimum PU dimension)
BC = 2   # chroma MC block size


# Edge padding of the reference planes for the contiguous-slice window
# fetch: windows whose MVs overreach the picture by <= MC_PAD pixels read
# the replicated border exactly (spec 8.5.4 edge clamp); frames with any
# larger overreach fall back to the per-element clamped gather (exact for
# arbitrary MVs).  16 px covers |mv| overreach of typical streams; the
# host checks per frame (mc_overreach).
MC_PAD = 16


@functools.partial(jax.jit, static_argnames=("block", "taps", "n_refs",
                                             "slice_pad"))
def _mc_blocks(refs, pos, ref_idx, mv, frac_filters, block: int, taps: int,
               n_refs: int, slice_pad: int = 0):
    """14-bit MC intermediates for n blocks.

    refs: [n_refs, H, W] int32 reference planes (stacked); when
    slice_pad > 0 they are edge-padded by that many pixels on each side
    and windows are fetched as CONTIGUOUS (1, span, span) dynamic slices
    instead of the per-element clamped gather (chip_smoke.py times both).
    pos: [n, 2] (y, x) block origin; ref_idx: [n]; mv: [n, 2] (mvx, mvy)
    frac_filters: [n, 2, taps] H and V filter taps for each block
    Returns [n, block, block] int32 (pre-rounding intermediates).
    """
    n = pos.shape[0]
    half = taps // 2 - 1
    unit = 2 if taps == 8 else 3          # quarter-pel luma / eighth-pel chroma
    ix = pos[:, 1] + (mv[:, 0] >> unit) - half
    iy = pos[:, 0] + (mv[:, 1] >> unit) - half
    span = block + taps - 1
    if slice_pad:
        win = jax.vmap(
            lambda r, y, x: jax.lax.dynamic_slice(
                refs, (r, y + slice_pad, x + slice_pad),
                (1, span, span))[0])(ref_idx, iy, ix)
    else:
        H, W = refs.shape[1], refs.shape[2]
        ys = jnp.clip(iy[:, None] + jnp.arange(span)[None, :], 0, H - 1)
        xs = jnp.clip(ix[:, None] + jnp.arange(span)[None, :], 0, W - 1)
        win = refs[ref_idx[:, None, None], ys[:, :, None], xs[:, None, :]]
    # horizontal: tmp[r, c] = sum_t fH[t] * win[r, c + t], then >> (bd-8)
    fh = frac_filters[:, 0]               # [n, taps]
    fv = frac_filters[:, 1]
    tmp = jnp.zeros((n, span, block), jnp.int32)
    for t in range(taps):
        tmp = tmp + fh[:, t][:, None, None] * win[:, :, t:t + block]
    tmp = tmp >> (BIT_DEPTH - 8)
    out = jnp.zeros((n, block, block), jnp.int32)
    for t in range(taps):
        out = out + fv[:, t][:, None, None] * tmp[:, t:t + block, :]
    return out >> 6


def _combine(p0, p1, has_l1, w_params):
    """uni/bi (+ explicit weighted) combination -> 8-bit samples.

    p1 may be None (stream proven uni-directional by the ShapePolicy): the
    bi path is then dropped from the compiled program entirely."""
    if w_params is None:
        uni = jnp.clip((p0 + (1 << 5)) >> 6, 0, 255)
        if p1 is None:
            return uni
        bi = jnp.clip((p0 + p1 + (1 << 6)) >> 7, 0, 255)
        return jnp.where(has_l1[:, None, None], bi, uni)
    w0, o0, w1, o1, log2_wd = w_params   # [n] each; log2_wd [n]
    shift_u = log2_wd + 6
    pu = (p0 * w0[:, None, None]
          + (1 << (shift_u - 1))[:, None, None]) >> shift_u[:, None, None]
    uni = jnp.clip(pu + o0[:, None, None], 0, 255)
    if p1 is None:
        return uni
    sb = (p0 * w0[:, None, None] + p1 * w1[:, None, None]
          + ((o0 + o1 + 1)[:, None, None] << (log2_wd + 6)[:, None, None]))
    bi = jnp.clip(sb >> (log2_wd + 7)[:, None, None], 0, 255)
    return jnp.where(has_l1[:, None, None], bi, uni)


# ---------------------------------------------------------------------------
# fused-program MC: traced prediction-plane builder + policy-padded host
# arrays.  Consumed by pipeline/batch_decode inside the SINGLE jitted program
# (refs stay device-resident in the DPB; zero host round trips per frame).
# ---------------------------------------------------------------------------


# MC block-size buckets: each inter PU is greedily tiled with the LARGEST
# fitting square blocks.  A (B+taps-1)^2 reference window serves a BxB
# block, so tiny blocks overfetch brutally (4x4 luma: 7.6x); bucketing cuts
# the dominant gather volume ~4x at 1080p while keeping shapes static.
LUMA_BUCKETS = (16, 8, 4)
CHROMA_BUCKETS = (8, 4, 2)


def mc_pred_plane(ref_planes, buckets, shape: tuple, taps: int,
                  has_bi: bool, wp_key: str, slice_pad: int = 0):
    """Traced: one component's MC prediction plane, inside the fused program.

    ref_planes: [n_refs, H, W] uint8 (device-resident DPB slabs)
    buckets: {block_size: dict} with pos [n,2] (y,x), r0/r1 [n], mv0/mv1
    [n,2], has1 [n] bool, and wp_<k> [n,5] weight rows -- identity weights
    (w=1, o=0, log2_wd=0) reproduce the unweighted rounding bit-exactly, so
    ONE code path serves WP and non-WP slices.
    has_bi: static -- False drops the second-list interpolation + bi combine
    from the program (uni-only streams pay for one gather, not two).
    Pad blocks carry pos=(H, 0): every scatter row lands out of bounds of
    the flattened plane and mode='drop' discards it.
    """
    fmask = 3 if taps == 8 else 7
    filt = jnp.asarray(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                       jnp.int32)
    refs = ref_planes.astype(jnp.int32)
    if slice_pad:
        refs = jnp.pad(refs, ((0, 0), (slice_pad, slice_pad),
                              (slice_pad, slice_pad)), mode="edge")
    H, W = shape
    flat_idx, flat_val = [], []
    for block in sorted(buckets, reverse=True):
        d = buckets[block]
        pos, mv0 = d["pos"], d["mv0"]
        f0 = jnp.stack([filt[mv0[:, 0] & fmask], filt[mv0[:, 1] & fmask]], 1)
        p0 = _mc_blocks.__wrapped__(refs, pos, d["r0"], mv0, f0, block,
                                    taps, refs.shape[0],
                                    slice_pad=slice_pad)
        p1 = None
        if has_bi:
            mv1 = d["mv1"]
            f1 = jnp.stack([filt[mv1[:, 0] & fmask],
                            filt[mv1[:, 1] & fmask]], 1)
            p1 = _mc_blocks.__wrapped__(refs, pos, d["r1"], mv1, f1, block,
                                        taps, refs.shape[0],
                                        slice_pad=slice_pad)
        wp = tuple(d[wp_key][:, k] for k in range(5))
        samp = _combine(p0, p1, d["has1"], wp)
        rows = pos[:, 0][:, None, None] + jnp.arange(block)[None, :, None]
        cols = pos[:, 1][:, None, None] + jnp.arange(block)[None, None, :]
        flat_idx.append((rows * W + cols).reshape(-1))
        flat_val.append(samp.reshape(-1))
    plane = jnp.zeros(H * W, jnp.int32)
    plane = plane.at[jnp.concatenate(flat_idx)].set(
        jnp.concatenate(flat_val), mode="drop")
    return plane.reshape(shape)


def mc_overreach(plan) -> int:
    """Host: max pixels any MC window reaches beyond the picture edges
    (both components, both lists) -- the exactness gate for the padded-
    slice window fetch (slightly conservative upper bound)."""
    pus = plan.pus
    if not pus:
        return 0
    W, H = plan.sps.pic_width, plan.sps.pic_height
    x = np.array([p.x for p in pus], np.int64)
    y = np.array([p.y for p in pus], np.int64)
    w = np.array([p.w for p in pus], np.int64)
    h = np.array([p.h for p in pus], np.int64)
    uses = np.array([[p.motion.uses(lx) for lx in range(2)] for p in pus],
                    bool)
    mv = np.array([p.motion.mv for p in pus], np.int64)  # [n, 2, 2]
    worst = 0
    for c_shift, taps in ((0, 8), (1, 4)):
        unit = 2 + c_shift
        cx, cy = x >> c_shift, y >> c_shift
        cw, ch = w >> c_shift, h >> c_shift
        CW, CH = W >> c_shift, H >> c_shift
        for lx in range(2):
            u = uses[:, lx]
            if not u.any():
                continue
            dx = mv[u, lx, 0] >> unit
            dy = mv[u, lx, 1] >> unit
            for base, d, size, lim in ((cx[u], dx, cw[u], CW),
                                       (cy[u], dy, ch[u], CH)):
                start = base + d - taps
                end = base + size + d + taps
                worst = max(worst, int(np.max(-start, initial=0)),
                            int(np.max(end - lim, initial=0)))
    return worst


def _tile_pu(x0: int, y0: int, w: int, h: int, sizes) -> list:
    """Greedy largest-square tiling of one PU rectangle -> [(y, x, size)].
    w/h are multiples of sizes[-1]; sizes are descending powers of two."""
    def decomp(n):
        segs = []
        for s in sizes:
            k = n // s
            segs.extend([s] * k)
            n -= k * s
        return segs
    out = []
    yo = 0
    for sy in decomp(h):
        xo = 0
        for sx in decomp(w):
            s = min(sx, sy)
            for dy in range(0, sy, s):
                for dx in range(0, sx, s):
                    out.append((y0 + yo + dy, x0 + xo + dx, s))
            xo += sx
        yo += sy
    return out


def _expand_blocks(xs, ys, ws, hs, B: int):
    """Vectorized: per-PU rectangles -> (pu_of [n], pos [n,2]) block grid."""
    nbx = ws // B
    counts = nbx * (hs // B)
    total = int(counts.sum())
    pu_of = np.repeat(np.arange(len(xs)), counts)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - start[pu_of]
    by = within // nbx[pu_of]
    bx = within - by * nbx[pu_of]
    pos = np.stack([ys[pu_of] + by * B, xs[pu_of] + bx * B], 1)
    return pu_of, pos.astype(np.int32)


def mc_arrays_padded(plan, poc_index: dict, pad_rows: dict):
    """Host: all inter PUs -> policy-padded, size-bucketed MC block arrays
    for the fused program.  Returns {"y": {block: {...}}, "c": {...}}
    (chroma cb/cr share geometry; weights are per-component: wp_1 for cb,
    wp_2 for cr; luma wp_0).

    pad_rows: {"y16": n, "y8": n, ..., "c2": n} per-bucket target row
    counts (ShapePolicy ladder)."""
    pus = plan.pus
    npu = len(pus)

    def pad_only(grp, block, ph):
        tgt = pad_rows[f"{grp}{block}"]
        d = dict(pos=np.full((tgt, 2), 0, np.int32),
                 mv0=np.zeros((tgt, 2), np.int32),
                 mv1=np.zeros((tgt, 2), np.int32),
                 r0=np.zeros(tgt, np.int32),
                 r1=np.zeros(tgt, np.int32),
                 has1=np.zeros(tgt, bool))
        d["pos"][:] = (ph, 0)
        wp = np.zeros((tgt, 5), np.int32)
        wp[:, 0] = wp[:, 2] = 1
        if grp == "y":
            d["wp_0"] = wp
        else:
            d["wp_1"], d["wp_2"] = wp, wp.copy()
        return d

    if npu == 0:
        # I picture inside a fused-MC stream: all-pad arrays, same program
        return {grp: {b: pad_only(grp, b, ph) for b in sizes}
                for grp, sizes, ph in
                (("y", LUMA_BUCKETS, plan.sps.pic_height),
                 ("c", CHROMA_BUCKETS, plan.sps.pic_height >> 1))}

    uses1 = np.array([p.motion.uses(1) for p in pus], bool)
    uses0 = np.array([p.motion.uses(0) for p in pus], bool)
    l0 = np.where(uses0, 0, 1)                   # first used list per PU
    mv = np.array([p.motion.mv for p in pus], np.int32).reshape(npu, 2, 2)
    rpoc = np.array([p.motion.ref_poc for p in pus], np.int64)
    ridx = np.array([p.motion.ref_idx for p in pus], np.int32)
    poc_map = {p: i for p, i in poc_index.items()}
    ar = np.zeros((npu, 2), np.int32)
    for lx in range(2):
        use = uses1 if lx else uses0
        for i in np.nonzero(use)[0]:
            ar[i, lx] = poc_map[int(rpoc[i, lx])]
    mv0 = mv[np.arange(npu), l0]
    r0 = ar[np.arange(npu), l0]
    has1 = uses0 & uses1
    mv1 = np.where(has1[:, None], mv[:, 1], 0).astype(np.int32)
    r1 = np.where(has1, ar[:, 1], 0).astype(np.int32)

    wt = None
    if ((plan.pps.weighted_pred and plan.sh.slice_type == 1)
            or (plan.pps.weighted_bipred and plan.sh.slice_type == 0)):
        wt = plan.sh.pred_weights
    # per-PU weight entries per component (identity when WP is off)
    wp_pu = np.zeros((3, npu, 5), np.int32)
    wp_pu[:, :, 0] = 1   # w0
    wp_pu[:, :, 2] = 1   # w1
    if wt is not None:
        for i, p in enumerate(pus):
            for c in range(3):
                denom = wt.luma_log2_denom if c == 0 else wt.chroma_log2_denom
                lwd = denom + (14 - BIT_DEPTH) - 6
                wp_pu[c, i, 4] = lwd
                off = 0 if c == 0 else 2 * c
                e0 = wt.get(int(l0[i]), int(ridx[i, l0[i]]))
                wp_pu[c, i, 0], wp_pu[c, i, 1] = e0[off], e0[off + 1]
                if has1[i]:
                    e1 = wt.get(1, int(ridx[i, 1]))
                    wp_pu[c, i, 2], wp_pu[c, i, 3] = e1[off], e1[off + 1]

    out = {}
    for grp, sizes, ph in (("y", LUMA_BUCKETS, plan.sps.pic_height),
                           ("c", CHROMA_BUCKETS, plan.sps.pic_height >> 1)):
        tiles = {b: [] for b in sizes}   # per bucket: (y, x, pu_idx)
        for i, p in enumerate(pus):
            if grp == "y":
                rect = (p.x, p.y, p.w, p.h)
            else:
                rect = (p.x >> 1, p.y >> 1, p.w >> 1, p.h >> 1)
            for (ty, tx, s) in _tile_pu(rect[0], rect[1], rect[2], rect[3],
                                        sizes):
                tiles[s].append((ty, tx, i))
        out[grp] = {}
        for b in sizes:
            rows = tiles[b]
            n = len(rows)
            tgt = pad_rows[f"{grp}{b}"]
            assert tgt >= n, (grp, b, tgt, n)
            if n == 0:
                out[grp][b] = pad_only(grp, b, ph)
                continue
            pos = np.array([(r[0], r[1]) for r in rows], np.int32)
            pu_of = np.array([r[2] for r in rows], np.int32)

            def padded(a, fill=0):
                full = np.full((tgt,) + a.shape[1:], fill, a.dtype)
                full[:n] = a
                return full

            d = dict(
                pos=padded(pos),
                mv0=padded(mv0[pu_of]),
                mv1=padded(mv1[pu_of]),
                r0=padded(r0[pu_of]),
                r1=padded(r1[pu_of]),
                has1=padded(has1[pu_of]),
            )
            d["pos"][n:] = (ph, 0)   # pad blocks: out-of-bounds -> dropped
            if grp == "y":
                d["wp_0"] = padded(wp_pu[0][pu_of])
            else:
                d["wp_1"] = padded(wp_pu[1][pu_of])
                d["wp_2"] = padded(wp_pu[2][pu_of])
            out[grp][b] = d
    return out


def mc_block_counts(plan) -> dict:
    """Host: per-bucket MC block counts (for ShapePolicy calibration)."""
    out = {f"{grp}{b}": 0 for grp in ("y", "c")
           for b in (LUMA_BUCKETS if grp == "y" else CHROMA_BUCKETS)}
    for p in plan.pus:
        for grp, sizes, rect in (
                ("y", LUMA_BUCKETS, (p.x, p.y, p.w, p.h)),
                ("c", CHROMA_BUCKETS,
                 (p.x >> 1, p.y >> 1, p.w >> 1, p.h >> 1))):
            for (_, _, s) in _tile_pu(*rect, sizes):
                out[f"{grp}{s}"] += 1
    return out


def mc_block_arrays(plan, c: int, poc_index: dict):
    """Host: flatten all inter PUs of component c into fixed-size MC block
    arrays (the device kernel's input layout).

    Returns None when the plane has no inter blocks, else a dict with
    pos [n,2], r0/r1 [n], mv0/mv1 [n,2], has1 [n], f0/f1 [n,2,taps] and
    wp (None or 5 [n] arrays: w0, o0, w1, o1, log2_wd)."""
    block = BL if c == 0 else BC
    taps = 8 if c == 0 else 4
    filt = LUMA_FILTER if c == 0 else CHROMA_FILTER
    fmask = 3 if c == 0 else 7
    wt = None
    if ((plan.pps.weighted_pred and plan.sh.slice_type == 1)
            or (plan.pps.weighted_bipred and plan.sh.slice_type == 0)):
        wt = plan.sh.pred_weights
    blocks = []   # (y, x, motion, wp entries)
    for pu in plan.pus:
        m = pu.motion
        x0, y0 = (pu.x, pu.y) if c == 0 else (pu.x >> 1, pu.y >> 1)
        pw, ph_ = (pu.w, pu.h) if c == 0 else (pu.w >> 1, pu.h >> 1)
        ents = None
        if wt is not None:
            ents = [wt.get(lx, m.ref_idx[lx]) if m.uses(lx) else None
                    for lx in range(2)]
        for by in range(y0, y0 + ph_, block):
            for bx in range(x0, x0 + pw, block):
                blocks.append((by, bx, m, ents))
    if not blocks:
        return None
    n = len(blocks)
    pos = np.array([[b[0], b[1]] for b in blocks], np.int32)
    r0 = np.zeros(n, np.int32)
    r1 = np.zeros(n, np.int32)
    mv0 = np.zeros((n, 2), np.int32)
    mv1 = np.zeros((n, 2), np.int32)
    has1 = np.zeros(n, bool)
    f0 = np.zeros((n, 2, taps), np.int32)
    f1 = np.zeros((n, 2, taps), np.int32)
    wp = None
    if wt is not None:
        wp = [np.zeros(n, np.int32) for _ in range(4)] + [
            np.full(n, (wt.luma_log2_denom if c == 0
                        else wt.chroma_log2_denom)
                    + (14 - BIT_DEPTH) - 6, np.int32)]
    for i, (by, bx, m, ents) in enumerate(blocks):
        lanes = [lx for lx in range(2) if m.uses(lx)]
        l0 = lanes[0]
        r0[i] = poc_index[m.ref_poc[l0]]
        mv0[i] = m.mv[l0]
        f0[i, 0] = filt[m.mv[l0][0] & fmask]
        f0[i, 1] = filt[m.mv[l0][1] & fmask]
        if len(lanes) == 2:
            has1[i] = True
            r1[i] = poc_index[m.ref_poc[1]]
            mv1[i] = m.mv[1]
            f1[i, 0] = filt[m.mv[1][0] & fmask]
            f1[i, 1] = filt[m.mv[1][1] & fmask]
        if wp is not None:
            comp_off = 0 if c == 0 else (2 * c)
            e0 = ents[l0]
            wp[0][i], wp[1][i] = e0[comp_off], e0[comp_off + 1]
            if len(lanes) == 2:
                e1 = ents[1]
                wp[2][i], wp[3][i] = e1[comp_off], e1[comp_off + 1]
    return dict(pos=pos, r0=r0, r1=r1, mv0=mv0, mv1=mv1, has1=has1,
                f0=f0, f1=f1, wp=wp, block=block, taps=taps)


def stamp_pcm(plan, out: list) -> None:
    """Overwrite PCM CU pixels with their parsed sample levels (host)."""
    for t in plan.tus:
        if t.pcm:
            sz = 1 << t.log2
            out[t.c_idx][t.y:t.y + sz, t.x:t.x + sz] = t.levels


def build_inter_pred_device(plan, refs: dict):
    """Device-side MC prediction planes (same contract as golden
    build_inter_pred); PCM blocks are still stamped on the host."""
    pcm_tus = [t for t in plan.tus if t.pcm]
    if not plan.pus and not pcm_tus:
        return None
    sps = plan.sps
    w, h = sps.pic_width, sps.pic_height
    poc_list = sorted(refs.keys())
    poc_index = {p: i for i, p in enumerate(poc_list)}
    out = []
    for c in range(3):
        shape = (h, w) if c == 0 else (h >> 1, w >> 1)
        ba = mc_block_arrays(plan, c, poc_index)
        if ba is None:
            out.append(np.zeros(shape, np.int32))
            continue
        block, taps = ba["block"], ba["taps"]
        pos = ba["pos"]
        ref_stack = np.stack([np.asarray(refs[p][c], np.int32)
                              for p in poc_list])
        p0 = _mc_blocks(jnp.asarray(ref_stack), jnp.asarray(pos),
                        jnp.asarray(ba["r0"]), jnp.asarray(ba["mv0"]),
                        jnp.asarray(ba["f0"]), block, taps, len(poc_list))
        p1 = _mc_blocks(jnp.asarray(ref_stack), jnp.asarray(pos),
                        jnp.asarray(ba["r1"]), jnp.asarray(ba["mv1"]),
                        jnp.asarray(ba["f1"]), block, taps, len(poc_list))
        wparams = None
        if ba["wp"] is not None:
            wparams = tuple(jnp.asarray(a) for a in ba["wp"])
        samp = _combine(p0, p1, jnp.asarray(ba["has1"]), wparams)
        plane = jnp.zeros(shape, jnp.int32)
        rows = pos[:, 0][:, None, None] + np.arange(block)[None, :, None]
        cols = pos[:, 1][:, None, None] + np.arange(block)[None, None, :]
        plane = plane.at[jnp.asarray(rows), jnp.asarray(cols)].set(samp)
        out.append(np.asarray(plane))
    stamp_pcm(plan, out)
    return out
