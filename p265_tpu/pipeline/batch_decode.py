"""Single-dispatch Stage-B: ONE upload, ONE jit call, ONE fetch per batch.

Per decoded batch we do exactly
  1. a handful of h2d uploads (one flat buffer per dtype: all compact TU
     arrays, gather maps, filter parameter grids),
  2. one jitted program: unpack -> residuals -> merged wavefront scan ->
     deblock (V+H) -> SAO -> bypass-pixel restore,
  3. one (optional, caller-side) d2h fetch of the stacked output planes.

Plane layout: all F luma segments first, then 2F chroma segments (cb then
cr), each of height h + GUARD inside one tall plane, so the filter stage can
reshape the scan output into [F, H, W] / [2F, Hc, Wc] batches with static
slicing only.

Compilation stability: per-TU array lengths are padded to powers of two and
step counts to multiples of 32, so the jit cache hits across frames/batches
of the same stream geometry.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from p265_tpu.kernels.itransform import batch_residual
from p265_tpu.kernels.loopfilter import (
    _deblock_chroma_vertical, _deblock_luma_vertical, _sao_apply,
    _sao_maps, chroma_edge_params, luma_edge_params)
from p265_tpu.pipeline.wavefront import (
    GUARD, _expand, _merge_segments, _pow2, _round_up, _scan_plane,
    _stack_plane)

# ---------------------------------------------------------------------------
# packing: list of numpy arrays -> one flat buffer PER DTYPE + static specs.
#
# Same-dtype slicing + reshape only: no device-side bitcasts of one big
# uint8 blob.  The cost is a handful of h2d uploads per batch (one per
# dtype) instead of one.
# ---------------------------------------------------------------------------


def _pack(arrays: list[np.ndarray]):
    """-> (tuple of per-dtype 1-D buffers, specs).

    specs: tuple of (buffer_idx, elem_offset, dtype_str, shape) per array.
    bool arrays travel as uint8 (device unpack restores via != 0)."""
    order = []        # dtype keys in first-seen order
    parts = {}        # dtype key -> list of flat arrays
    offs = {}         # dtype key -> current element offset
    specs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        key = "|b1" if a.dtype == np.bool_ else a.dtype.str
        store = a.view(np.uint8) if a.dtype == np.bool_ else a
        if key not in parts:
            parts[key] = []
            offs[key] = 0
            order.append(key)
        specs.append((order.index(key), offs[key], a.dtype.str, a.shape))
        parts[key].append(store.reshape(-1))
        offs[key] += store.size
    bufs = tuple(np.concatenate(parts[k]) if parts[k]
                 else np.zeros(1, np.dtype(k)) for k in order)
    return bufs, tuple(specs)


def _unpack(bufs, specs):
    """Device: per-dtype buffers -> list of arrays per specs (static slices,
    no bitcasts)."""
    out = []
    for buf_idx, off, dtype_str, shape in specs:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64))
        raw = jax.lax.slice_in_dim(bufs[buf_idx], off, off + n)
        if dt == np.bool_:
            a = raw != 0
        else:
            a = raw
        out.append(a.reshape(shape))
    return out


# ---------------------------------------------------------------------------
# host: build the per-batch blob
# ---------------------------------------------------------------------------

_TU_FIELDS = ("pos", "ref_ys", "ref_xs", "ref_ok", "mode", "filter_flag",
              "strong_allowed", "inter", "dc_edge", "coeffs", "qp", "is_dst",
              "tskip", "bypass", "scale_m", "idx_map", "counts")

# fields of the hoisted inter-TU apply (pred + residual, no scan)
_ITU_FIELDS = ("pos", "coeffs", "qp", "tskip", "bypass", "scale_m")


def _hoist_inter(merged, policy):
    """Pull every inter-predicted TU OUT of the wavefront scan.

    Inter TUs have no in-frame sample dependencies (their prediction is the
    MC plane), so they all sit at wavefront step 1 -- which explodes the
    per-step lane cap (a 416x240 P frame puts ~1500 TUs in one step) and
    with ladder-stable caps makes EVERY step pay that width.  Applying them
    as one vectorized gather+scatter BEFORE the scan ("step 0") keeps the
    dependency order (intra consumers of inter samples sit at step >= 2)
    and shrinks the scan to the intra wavefront only.

    Mutates merged.batches in place (intra-only); returns {log2: fields} of
    compact inter-apply arrays (each with one trailing pad row scattering
    into the guard region), or None when the program needs no inter apply.
    """
    import dataclasses
    ph = merged.shape[0]
    force = policy is not None and (policy.want_pred or policy.saw_pus)
    out = {}
    for log2, b in list(merged.batches.items()):
        m = np.asarray(b.inter)
        if not m.any() and not force:
            continue
        keep = ~m

        def sub(a, sel):
            return None if a is None else a[sel]

        coord_dt = b.pos.dtype
        d = dict(pos=np.concatenate([b.pos[m],
                                     np.array([[ph, 0]], coord_dt)]),
                 coeffs=np.concatenate(
                     [b.coeffs[m],
                      np.zeros((1,) + b.coeffs.shape[1:], b.coeffs.dtype)]),
                 qp=np.concatenate([b.qp[m], np.zeros(1, b.qp.dtype)]),
                 tskip=np.concatenate([b.tskip[m], np.zeros(1, bool)]),
                 bypass=np.concatenate([b.bypass[m], np.zeros(1, bool)]))
        if b.scale_m is not None:
            d["scale_m"] = np.concatenate(
                [b.scale_m[m],
                 np.full((1,) + b.scale_m.shape[1:], 16, b.scale_m.dtype)])
        n1 = d["pos"].shape[0]
        tgt = (policy.inter_rows(log2, n1) if policy is not None
               else _pow2(n1, lo=8))
        out[log2] = {k: _pad_rows(a, tgt) for k, a in d.items()}
        if m.any():
            merged.batches[log2] = dataclasses.replace(
                b, **{f: sub(getattr(b, f), keep) for f in (
                    "pos", "step", "coeffs", "qp", "mode", "c_idx", "is_dst",
                    "tskip", "has_res", "bypass", "scale_m", "inter",
                    "filter_flag", "strong_allowed", "dc_edge", "ref_ys",
                    "ref_xs", "ref_ok", "ok_scan")})
    return out or None


def _pad_rows(a: np.ndarray, tgt: int) -> np.ndarray:
    """Pad axis 0 (n+1 rows, pad row last) to tgt rows by repeating the pad
    row -- keeps jit shapes stable across frames."""
    n1 = a.shape[0]
    if tgt <= n1:
        return a
    rep = np.repeat(a[-1:], tgt - n1, axis=0)
    return np.concatenate([a, rep])


def filter_params(plans: list):
    """Host: the loop-filter inputs of F same-flag frames -> (grids, deblock,
    sao_luma, sao_chroma), grids being {name: stacked int16/int8 array}.

    The batch is filtered with ONE set of flags; heterogeneous batches must
    be split by the caller (mirrors the guard in
    loopfilter.loop_filters_tpu_frames)."""
    def _fsig(p):
        return (p.sh.deblocking_filter_disabled,
                p.sps.sao_enabled and p.sh.sao_luma,
                p.sps.sao_enabled and p.sh.sao_chroma)
    sigs = {_fsig(p) for p in plans}
    assert len(sigs) == 1, (
        "decode_batch: frames with heterogeneous filter flags in one batch: "
        f"{sigs}; split into homogeneous sub-batches")
    grids = {}
    deblock_on = not plans[0].sh.deblocking_filter_disabled
    if deblock_on:
        for vertical in (True, False):
            lp = [luma_edge_params(p, vertical) for p in plans]
            cp = [chroma_edge_params(p, vertical) for p in plans]
            key = "v" if vertical else "h"
            grids[f"bs_{key}"] = np.stack([x[0] for x in lp]).astype(np.int16)
            grids[f"beta_{key}"] = np.stack([x[1] for x in lp]).astype(
                np.int16)
            grids[f"tc_{key}"] = np.stack([x[2] for x in lp]).astype(np.int16)
            grids[f"tcc_{key}"] = np.stack([x[0] for x in cp]
                                           + [x[1] for x in cp]).astype(
                                               np.int16)
    sao_luma = plans[0].sps.sao_enabled and plans[0].sh.sao_luma
    sao_chroma = plans[0].sps.sao_enabled and plans[0].sh.sao_chroma
    for c, on in ((0, sao_luma), (1, sao_chroma)):
        if not on:
            continue
        # order must match the plane layout: lumas / all-cb then all-cr
        maps = [_sao_maps(p, cc) for cc in ((0,) if c == 0 else (1, 2))
                for p in plans]
        for i, name in enumerate(("ty", "cls", "off")):
            grids[f"sao_{name}_{c}"] = np.stack([m[i] for m in maps]).astype(
                np.int8)
    return grids, deblock_on, sao_luma, sao_chroma


def loop_filter_planes(luma, chroma, fp: dict, deblock: bool,
                       sao_luma: bool, sao_chroma: bool, ctb: int):
    """Traced: deblock (V then H) + SAO of F luma [F,H,W] and 2F chroma
    [2F,Hc,Wc] int32 planes with filter_params grids -> (luma, chroma)."""
    if deblock:
        for key in ("v", "h"):
            if key == "h":
                luma = jnp.swapaxes(luma, 1, 2)
                chroma = jnp.swapaxes(chroma, 1, 2)
            bs = fp[f"bs_{key}"].astype(jnp.int32)
            if bs.shape[2]:
                luma = jax.vmap(_deblock_luma_vertical.__wrapped__)(
                    luma, bs, fp[f"beta_{key}"].astype(jnp.int32),
                    fp[f"tc_{key}"].astype(jnp.int32))
            tcc = fp[f"tcc_{key}"].astype(jnp.int32)
            if tcc.shape[2]:
                chroma = jax.vmap(_deblock_chroma_vertical.__wrapped__)(
                    chroma, tcc)
            if key == "h":
                luma = jnp.swapaxes(luma, 1, 2)
                chroma = jnp.swapaxes(chroma, 1, 2)
    if sao_luma:
        luma = jax.vmap(_sao_apply.__wrapped__, in_axes=(0, 0, 0, 0, None))(
            luma, fp["sao_ty_0"].astype(jnp.int32),
            fp["sao_cls_0"].astype(jnp.int32),
            fp["sao_off_0"].astype(jnp.int32), ctb)
    if sao_chroma:
        chroma = jax.vmap(_sao_apply.__wrapped__, in_axes=(0, 0, 0, 0, None))(
            chroma, fp["sao_ty_1"].astype(jnp.int32),
            fp["sao_cls_1"].astype(jnp.int32),
            fp["sao_off_1"].astype(jnp.int32), ctb >> 1)
    return luma, chroma


def _build_batch(tplans: list, plans: list, policy=None, mc=None,
                 mc_pad: int = 0):
    """-> (bufs, static_meta) for one batch of F same-resolution frames.

    policy: optional ShapePolicy -- quantizes every data-dependent shape to
    stream-stable ladder values so one compile serves the whole stream.
    mc: optional PER-FRAME list of fused-MC block arrays (one
    kernels.mc.mc_arrays_padded dict per tplan): each frame's prediction
    planes are then computed INSIDE the program from that frame's
    device-resident reference slabs instead of being uploaded densely.
    F>1 with mc is the frame-DAG batch path (mutually independent frames,
    e.g. hierarchical-B siblings, in ONE dispatch).
    """
    F = len(tplans)
    if mc is not None and not isinstance(mc, (list, tuple)):
        mc = [mc]
    assert mc is None or len(mc) == F, "one MC dict per frame"
    sps = plans[0].sps
    H, W = sps.pic_height, sps.pic_width
    Hc, Wc = H >> 1, W >> 1
    # plane order: lumas, then cb's, then cr's
    pps_ = ([tp.planes[0] for tp in tplans] + [tp.planes[1] for tp in tplans]
            + [tp.planes[2] for tp in tplans])
    merged, offs = _merge_segments(pps_, policy=policy,
                                   host_pred=mc is None)
    itu = _hoist_inter(merged, policy)
    n_steps, stacked = _stack_plane(merged, policy=policy)
    if policy is None:
        n_steps = _round_up(n_steps, 32)

    arrays = []
    tu_specs = {}
    for log2 in sorted(stacked):
        d = stacked[log2]
        n1 = d["pos"].shape[0]
        rows_tgt = (policy.rows(log2, n1) if policy is not None
                    else _pow2(n1, lo=8))
        im = d["idx_map"]
        if im.shape[0] < n_steps:  # re-pad idx_map rows to the rounded count
            n = n1 - 1
            extra = np.full((n_steps - im.shape[0], im.shape[1]), n, np.int32)
            im = np.concatenate([im, extra])
        fields = {}
        for f in _TU_FIELDS:
            if f == "idx_map":
                a = im
            elif f == "counts":
                a = d[f]
                if a.shape[0] < n_steps:
                    a = np.concatenate(
                        [a, np.zeros(n_steps - a.shape[0], a.dtype)])
            elif f == "scale_m" and f not in d:     # optional field
                continue
            else:
                a = _pad_rows(d[f], rows_tgt)
            fields[f] = len(arrays)
            arrays.append(a)
        tu_specs[log2] = fields

    fp = {}
    grids, deblock_on, sao_luma, sao_chroma = filter_params(plans)
    for k, a in grids.items():
        fp[k] = len(arrays)
        arrays.append(a)

    # bypass pixel masks (cu_transquant_bypass / PCM): rare; packed only when
    # present anywhere in the batch
    from p265_tpu.golden.decoder import bypass_pixel_masks
    masks = [bypass_pixel_masks(p) for p in plans]
    has_masks = (any(m is not None for m in masks)
                 or (policy is not None and policy.want_masks))
    if has_masks:
        my = np.stack([(m[0] if m is not None else np.zeros((H, W), bool))
                       for m in masks])
        # chroma mask order must match chroma plane order (cb's then cr's)
        mch = np.stack([(m[c] if m is not None else np.zeros((Hc, Wc), bool))
                        for c in (1, 2) for m in masks])
        fp["mask_y"] = len(arrays)
        arrays.append(my)
        fp["mask_c"] = len(arrays)
        arrays.append(mch)

    pred = None
    if merged.inter_pred is not None:
        fp["pred"] = len(arrays)
        arrays.append(np.clip(merged.inter_pred, 0, 255).astype(np.uint8))

    mc_specs = None
    mc_bi = False
    if mc is not None:
        mc_bi = policy is not None and policy.saw_bi
        per_frame = []
        for fmc in mc:
            mcs = []
            for grp in ("y", "c"):
                for block in sorted(fmc[grp]):
                    fields = {}
                    for f, a in sorted(fmc[grp][block].items()):
                        fields[f] = len(arrays)
                        arrays.append(np.ascontiguousarray(a))
                    mcs.append((grp, block, tuple(sorted(fields.items()))))
            per_frame.append(tuple(mcs))
        mc_specs = tuple(per_frame)

    itu_specs = None
    if itu is not None:
        its = []
        for log2 in sorted(itu):
            fields = {}
            for f in _ITU_FIELDS:
                if f not in itu[log2]:
                    continue
                fields[f] = len(arrays)
                arrays.append(itu[log2][f])
            its.append((log2, tuple(sorted(fields.items()))))
        itu_specs = tuple(its)

    bufs, specs = _pack(arrays)
    sizes = tuple(sorted(merged.batches.keys()))
    tu_field_specs = tuple(sorted(
        (log2, tuple(sorted(fields.items()))) for log2, fields in
        tu_specs.items()))
    meta = dict(
        F=F, shape=merged.shape, seg_h=H + GUARD, seg_hc=Hc + GUARD,
        H=H, W=W, Hc=Hc, Wc=Wc, sizes=sizes,
        tu=tu_field_specs, fp=tuple(sorted(fp.items())),
        specs=specs, deblock=deblock_on, sao_luma=sao_luma,
        sao_chroma=sao_chroma, ctb=sps.ctb_size, has_masks=has_masks,
        mc=mc_specs, mc_bi=mc_bi, itu=itu_specs,
    )
    return bufs, _freeze(meta)


def _freeze(d):
    return tuple(sorted(d.items()))


def _thaw(t):
    return dict(t)


# ---------------------------------------------------------------------------
# device: the single program
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("meta", "use_mxu"))
def _decode_batch_jit(bufs, meta, use_mxu: bool = True, refs=None):
    m = _thaw(meta)
    arrays = _unpack(bufs, m["specs"])
    tu = {}
    idx_maps = {}
    for log2, fields in m["tu"]:
        d = {f: arrays[i] for f, i in fields}
        idx_maps[log2] = d.pop("idx_map")
        tu[log2] = d
    fp = {k: arrays[i] for k, i in m["fp"]}

    pred = None
    if "pred" in fp:
        pred = fp["pred"].astype(jnp.int32)
    if m.get("mc") is not None:
        # fused MC: per-frame prediction planes computed here from each
        # frame's device-resident reference slabs (refs = per-frame 3-tuples
        # of tuples of [H,W]/[Hc,Wc] uint8 planes); frame-DAG batches (F>1)
        # place each frame's planes at its segment offsets
        from p265_tpu.kernels.mc import mc_pred_plane
        Hf, Wf, Hcf, Wcf = m["H"], m["W"], m["Hc"], m["Wc"]
        F_, seg_h, seg_hc = m["F"], m["seg_h"], m["seg_hc"]
        total_h, pw = m["shape"]
        pred = jnp.zeros((total_h, pw), jnp.int32)
        for f, mspec in enumerate(m["mc"]):
            g = {"y": {}, "c": {}}
            for grp, block, fields in mspec:
                g[grp][block] = {fl: arrays[i] for fl, i in fields}
            rf = refs[f]

            def _mc(grp, stack, wp_key, shape, taps):
                return mc_pred_plane(stack, g[grp], shape, taps,
                                     m["mc_bi"], wp_key,
                                     slice_pad=m.get("mc_pad", 0))

            pred_y = _mc("y", jnp.stack(rf[0]), "wp_0", (Hf, Wf), 8)
            pred_cb = _mc("c", jnp.stack(rf[1]), "wp_1", (Hcf, Wcf), 4)
            pred_cr = _mc("c", jnp.stack(rf[2]), "wp_2", (Hcf, Wcf), 4)
            oy = f * seg_h
            o1 = F_ * seg_h + f * seg_hc
            o2 = F_ * seg_h + (F_ + f) * seg_hc
            pred = pred.at[oy:oy + Hf, :Wf].set(pred_y)
            pred = pred.at[o1:o1 + Hcf, :Wcf].set(pred_cb)
            pred = pred.at[o2:o2 + Hcf, :Wcf].set(pred_cr)
    init = None
    if m["itu"] is not None:
        # hoisted inter TUs (all wavefront "step 0"): scatter their
        # residuals into a plane with ONE flat merged scatter, then
        # init = clip(pred + residuals) over the whole plane.  Regions
        # belonging to intra TUs get pred garbage that the scan
        # overwrites.
        total_h, pw = m["shape"]
        psrc = (pred if pred is not None
                else jnp.zeros((total_h, pw), jnp.int32))
        psrc = jnp.concatenate(
            [psrc, jnp.zeros((GUARD, pw), jnp.int32)])
        flat_idx, flat_val = [], []
        for log2, fields in m["itu"]:
            d = {f: arrays[i] for f, i in fields}
            sm = d.get("scale_m")
            res = batch_residual.__wrapped__(
                d["coeffs"].astype(jnp.int32), d["qp"].astype(jnp.int32),
                jnp.zeros(d["qp"].shape[0], bool), d["tskip"], log2,
                use_mxu, bypass=d["bypass"],
                scale_m=None if sm is None else sm.astype(jnp.int32))
            s = 1 << log2
            p = d["pos"].astype(jnp.int32)
            rows = p[:, 0][:, None, None] + jnp.arange(s)[None, :, None]
            cols = p[:, 1][:, None, None] + jnp.arange(s)[None, None, :]
            flat_idx.append((rows * pw + cols).reshape(-1))
            flat_val.append(res.reshape(-1))
        res_plane = jnp.zeros((total_h + GUARD) * pw, jnp.int32)
        res_plane = res_plane.at[jnp.concatenate(flat_idx)].set(
            jnp.concatenate(flat_val), mode="drop")
        init = jnp.clip(psrc + res_plane.reshape(total_h + GUARD, pw),
                        0, 255)
        pred = None  # scan TUs are intra-only now
    stacked = _expand(tu, idx_maps, m["sizes"], use_mxu)
    plane = _scan_plane(stacked, m["sizes"], 0, m["shape"], pred,
                        init_plane=init)

    F, H, W, Hc, Wc = m["F"], m["H"], m["W"], m["Hc"], m["Wc"]
    seg_h, seg_hc = m["seg_h"], m["seg_hc"]
    total_h, pw = m["shape"]
    # append the missing trailing guard so both regions reshape cleanly
    need = F * seg_h + 2 * F * seg_hc
    plane = jnp.concatenate(
        [plane, jnp.zeros((need - total_h, pw), jnp.int32)])
    luma = plane[:F * seg_h].reshape(F, seg_h, pw)[:, :H, :W]
    ch = plane[F * seg_h:F * seg_h + 2 * F * seg_hc]
    chroma = ch.reshape(2 * F, seg_hc, pw)[:, :Hc, :Wc]
    pre_luma, pre_chroma = luma, chroma

    luma, chroma = loop_filter_planes(luma, chroma, fp, m["deblock"],
                                      m["sao_luma"], m["sao_chroma"], m["ctb"])
    if m["has_masks"]:
        luma = jnp.where(fp["mask_y"], pre_luma, luma)
        chroma = jnp.where(fp["mask_c"], pre_chroma, chroma)
    return (pre_luma.astype(jnp.uint8), pre_chroma.astype(jnp.uint8),
            luma.astype(jnp.uint8), chroma.astype(jnp.uint8))


def decode_batch_planes(tplans: list, plans: list, use_mxu: bool = True,
                        policy=None, mc=None, refs=None, stats=None,
                        mc_pad: int = 0):
    """F frame plans -> (pre_luma [F,H,W]u8, pre_chroma [2F]..., luma, chroma)
    device arrays via one dispatch (a few per-dtype uploads).

    mc + refs: fused-MC inputs (see _build_batch); refs is a per-frame
    tuple of 3-tuples of equal-length tuples of device uint8 reference
    planes (y, cb, cr) -- a single bare 3-tuple is accepted for F=1.
    stats: optional dict accumulating pack_s / upload_s / dispatch_s."""
    import time as _time
    t0 = _time.perf_counter()
    if refs is not None and refs and not isinstance(refs[0][0],
                                                    (tuple, list)):
        refs = (refs,)    # legacy F=1 call shape
    bufs, meta = _build_batch(tplans, plans, policy=policy, mc=mc,
                              mc_pad=mc_pad)
    t1 = _time.perf_counter()
    dbufs = tuple(jnp.asarray(b) for b in bufs)
    t2 = _time.perf_counter()
    out = _decode_batch_jit(dbufs, meta, use_mxu, refs=refs)
    if stats is not None:
        t3 = _time.perf_counter()
        stats["pack_s"] = stats.get("pack_s", 0.0) + (t1 - t0)
        stats["upload_s"] = stats.get("upload_s", 0.0) + (t2 - t1)
        stats["dispatch_s"] = stats.get("dispatch_s", 0.0) + (t3 - t2)
    return out


def decode_batch(tplans: list, plans: list, use_mxu: bool = True,
                 policy=None):
    """Convenience: -> (prefilter, filtered) as per-frame [y, cb, cr] device
    arrays (chroma order restored)."""
    F = len(tplans)
    pl, pc, fl, fc = decode_batch_planes(tplans, plans, use_mxu,
                                         policy=policy)
    pre = [[pl[f], pc[f], pc[F + f]] for f in range(F)]
    filt = [[fl[f], fc[f], fc[F + f]] for f in range(F)]
    return pre, filt
