"""Spatially sharded Stage-B: ONE picture's recon + loop filters over the
'space' mesh axis (SURVEY.md §2.3 halo row, §5 sequence-parallel analogue;
configs 4/5 of BASELINE.json).

Design (codec-native sequence parallelism — the CTU grid is the "sequence"):

- The picture is split into CTU-row blocks, one per device.  HEVC intra
  prediction reads reference samples only from the row immediately above a
  TU (p[x..x+2N-1][y-1]) and from its own left column (p[x-1][y-1..y+2N-1]);
  with CTU-aligned blocks, below-left references never cross a block
  boundary (raster decode order makes them unavailable there).  So the
  wavefront scan shards with a ONE-ROW halo: after every wavefront step each
  device `ppermute`s its bottom reconstructed row to the next device, whose
  top-halo reads are then exact (the global step numbering guarantees every
  producer ran at an earlier step than its consumer).
- Motion compensation reads arbitrary rows of the reference pictures (MVs
  are unconstrained within the level's range), so the row-sharded DPB slabs
  are `all_gather`ed inside the shard_map before the local gather+filter —
  the exact collective the north star names for DPB reference slabs.
- Deblocking shards with a 4-row halo (an H edge on the block boundary reads
  p3..q3 = 4 rows on each side; the V pass is row-local).  SAO shards with a
  1-row halo (shard/filters.sao_sharded).

Everything is REQUIRED to be bit-exact vs the unsharded single-chip path
(tests/test_spatial.py; determinism is the sanitizer, SURVEY.md §5).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from p265_tpu.kernels.intra import predict_batch
from p265_tpu.kernels.intra_mxu import predict_batch_mxu
from p265_tpu.kernels.itransform import batch_residual
from p265_tpu.kernels.loopfilter import (_deblock_chroma_vertical,
                                         _deblock_luma_vertical,
                                         chroma_edge_params, luma_edge_params)
from p265_tpu.kernels.mc import _combine, _mc_blocks, mc_block_arrays
from p265_tpu.pipeline.wavefront import GUARD, USE_MXU_INTRA, _pow2, \
    _stack_plane
from p265_tpu.syntax.ctu import FramePlan

# ---------------------------------------------------------------------------
# row-sharded wavefront reconstruction (1-row ppermute halo per step)
# ---------------------------------------------------------------------------


def _device_idx_maps(stacked: dict, n_steps: int, hl: int, n_dev: int):
    """Per-device [n_steps, cap] gather maps: device d's map selects only the
    TUs whose rows fall in block d (pos[0] // hl == d); cap is the fleet max
    so shapes are uniform for shard_map."""
    out = {}
    for log2, d in stacked.items():
        im, pos = d["idx_map"], d["pos"]          # [n_steps', cap'], [n+1, 2]
        n = pos.shape[0] - 1
        dev_of = np.minimum(pos[:, 0] // hl, n_dev - 1).astype(np.int32)
        dev_of[n] = -1                            # pad row: no device
        maps = []
        cap = 1
        for dev in range(n_dev):
            rows = []
            for s in range(im.shape[0]):
                sel = im[s][(im[s] < n) & (dev_of[im[s]] == dev)]
                rows.append(sel)
                cap = max(cap, len(sel))
            maps.append(rows)
        cap = _pow2(cap)
        dm = np.full((n_dev, n_steps, cap), n, np.int32)
        for dev in range(n_dev):
            for s, sel in enumerate(maps[dev]):
                dm[dev, s, :len(sel)] = sel
        out[log2] = dm
    return out


def _scan_plane_spatial(tu, idx_maps, sizes, c_idx, shape, hl, axis,
                        pred_local=None):
    """Device body (inside shard_map): sharded wavefront scan over the local
    row block with a 1-row top halo refreshed by ppermute after every step.

    tu: replicated compact per-TU dicts; idx_maps: local [1, n_steps, cap]
    gather maps; pred_local: [1, hl(+c), pw] local MC prediction rows."""
    ph, pw = shape
    n = jax.lax.axis_size(axis)
    r0 = jax.lax.axis_index(axis) * hl
    fwd = [(i, i + 1) for i in range(n - 1)]

    has_inter = pred_local is not None
    ext_rows = 1 + hl + GUARD
    if has_inter:
        pred_pad = jnp.zeros((ext_rows, pw), jnp.int32)
        pred_pad = pred_pad.at[1:1 + hl].set(pred_local[0])
    else:
        pred_pad = None

    stacked = {}
    for log2 in sizes:
        d = tu[log2]
        im = idx_maps[log2][0]                    # [n_steps, cap]
        sm = d.get("scale_m")
        res = batch_residual.__wrapped__(
            d["coeffs"].astype(jnp.int32), d["qp"].astype(jnp.int32),
            d["is_dst"], d["tskip"], log2, True, bypass=d["bypass"],
            scale_m=None if sm is None else sm.astype(jnp.int32))
        # localize coordinates: plane row y -> ext row y - r0 + 1 (halo at 0)
        lpos = d["pos"].astype(jnp.int32)
        lpos = lpos.at[:, 0].add(1 - r0)
        lpos = lpos.at[:, 0].set(jnp.clip(lpos[:, 0], 0, hl + 1))
        # pin the pad TU (last row) into the local guard on EVERY device --
        # with padded blocks its global row can fall inside a real block
        lpos = lpos.at[-1, 0].set(hl + 1)
        lpos = lpos.at[-1, 1].set(0)
        lys = jnp.clip(d["ref_ys"].astype(jnp.int32) + (1 - r0), 0, hl)
        stacked[log2] = dict(
            pos=lpos[im], ref_ys=lys[im],
            ref_xs=d["ref_xs"].astype(jnp.int32)[im],
            ref_ok=d["ref_ok"][im], mode=d["mode"].astype(jnp.int32)[im],
            filter_flag=d["filter_flag"][im],
            strong_allowed=d["strong_allowed"][im],
            inter=d["inter"][im], dc_edge=d["dc_edge"][im], residual=res[im])

    ext = jnp.zeros((ext_rows, pw), jnp.int32)
    pred_fn = predict_batch_mxu if USE_MXU_INTRA else predict_batch

    def body(ext, step_data):
        for log2 in sizes:
            d = step_data[log2]
            ext = pred_fn.__wrapped__(
                ext, d["pos"], d["ref_ys"], d["ref_xs"], d["ref_ok"],
                d["mode"], d["filter_flag"], d["strong_allowed"],
                d["residual"], 1 << log2, c_idx,
                inter=d["inter"] if has_inter else None,
                pred_plane=pred_pad if has_inter else None,
                dc_edge=d["dc_edge"])
        # hand the bottom owned row to the next block's top halo
        halo = jax.lax.ppermute(ext[hl], axis, fwd)
        ext = ext.at[0].set(halo)
        return ext, None

    ext, _ = jax.lax.scan(body, ext, stacked)
    return ext[1:1 + hl][None]                    # [1, hl, pw] local rows


def _block_rows(ph: int, n_dev: int, align: int) -> int:
    """CTU-aligned per-device row-block height covering a plane of ph rows
    (real pictures are rarely n_dev*CTU multiples -- 1080 rows = 16.875
    CTUs -- so the shard wrappers pad to hl*n_dev and slice the result)."""
    return align * -(-ph // (n_dev * align))


def reconstruct_spatial(tplan, mesh: Mesh, axis: str = "space",
                        pred_planes: list | None = None) -> list:
    """Row-sharded Stage-B reconstruction of ONE picture over mesh[axis].

    Returns [y, cb, cr] numpy planes, bit-exact vs reconstruct_tpu_scan.
    Works on any picture geometry: row blocks are padded up to CTU-aligned
    heights (trailing devices own empty rows) and the output is sliced back.
    pred_planes: optional [3] MC prediction planes (e.g. from mc_spatial);
    defaults to the tensor plan's own inter_pred."""
    n_dev = mesh.shape[axis]
    sps = tplan.frame_plan.sps
    ctb = sps.ctb_size
    flat_in, in_specs, plane_meta = [], [], []
    for p_idx, pp in enumerate(tplan.planes):
        ph, pw = pp.shape
        hl = _block_rows(ph, n_dev, ctb if p_idx == 0 else ctb >> 1)
        n_steps, stacked = _stack_plane(pp)
        sizes = tuple(sorted(pp.batches.keys()))
        tu = {log2: {k: jnp.asarray(v) for k, v in d.items()
                     if k not in ("idx_map", "okc", "pos4", "counts")}
              for log2, d in stacked.items()}
        dmaps = {log2: jnp.asarray(m) for log2, m in
                 _device_idx_maps(stacked, n_steps, hl, n_dev).items()}
        pred = pp.inter_pred if pred_planes is None else pred_planes[p_idx]
        if pred is None:
            pred_dev = None
        else:
            pr = np.asarray(pred, np.int32)
            if pr.shape[0] < n_dev * hl:
                pr = np.pad(pr, ((0, n_dev * hl - pr.shape[0]), (0, 0)))
            pred_dev = jnp.asarray(pr.reshape(n_dev, hl, pw))
        flat_in += [tu, dmaps] + ([pred_dev] if pred_dev is not None else [])
        in_specs += [jax.tree.map(lambda _: P(), tu,
                                  is_leaf=lambda l: hasattr(l, "shape")),
                     jax.tree.map(lambda _: P(axis), dmaps,
                                  is_leaf=lambda l: hasattr(l, "shape"))]
        if pred_dev is not None:
            in_specs.append(P(axis))
        plane_meta.append((sizes, pp.shape, hl, pred_dev is not None))

    def body(*flat):
        it = iter(flat)
        outs = []
        for p_idx, (sizes, shape, hl, has_pred) in enumerate(plane_meta):
            tu = next(it)
            dmaps = next(it)
            pred_local = next(it) if has_pred else None
            if not sizes:
                outs.append(jnp.zeros((1, hl, shape[1]), jnp.int32))
                continue
            outs.append(_scan_plane_spatial(
                tu, dmaps, sizes, min(p_idx, 1), shape, hl, axis, pred_local))
        return tuple(outs)

    fn = jax.shard_map(body, mesh=mesh, in_specs=tuple(in_specs),
                       out_specs=(P(axis),) * 3, check_vma=False)
    outs = jax.jit(fn)(*flat_in)
    return [np.asarray(o).reshape(-1, pp.shape[1])[:pp.shape[0]]
            for o, pp in zip(outs, tplan.planes)]


# ---------------------------------------------------------------------------
# MC from a row-sharded DPB: all_gather the reference slabs, filter locally
# ---------------------------------------------------------------------------


def shard_refs(refs: dict, mesh: Mesh, axis: str = "space",
               pad_rows: list | None = None):
    """Place DPB reference planes row-sharded over mesh[axis].

    refs: {poc: [y, cb, cr]} -> (poc_list, [3] device arrays
    [n_refs, H(c), W(c)] with the row dim sharded).

    pad_rows: optional [3] per-component row targets (multiples of the mesh
    size).  Padding REPLICATES the last row, so the MC gather's edge clamp
    to the padded height reads exactly the spec's edge-extended samples."""
    poc_list = sorted(refs.keys())
    stacks = []
    for c in range(3):
        stack = np.stack([np.asarray(refs[p][c], np.int32) for p in poc_list])
        if pad_rows is not None and stack.shape[1] < pad_rows[c]:
            stack = np.pad(stack, ((0, 0), (0, pad_rows[c] - stack.shape[1]),
                                   (0, 0)), mode="edge")
        sh = NamedSharding(mesh, P(None, axis, None))
        stacks.append(jax.device_put(stack, sh))
    return poc_list, stacks


def _partition_blocks(ba: dict, hl: int, n_dev: int):
    """Split MC block arrays by owning row block; pad to a uniform cap.
    Dummy blocks scatter into the local guard row (pos y = hl)."""
    dev = np.minimum(ba["pos"][:, 0] // hl, n_dev - 1)
    cap = max(1, int(np.bincount(dev, minlength=n_dev).max()))
    cap = _pow2(cap)

    def pad(a, fill=0):
        out = np.full((n_dev, cap) + a.shape[1:], fill, a.dtype)
        for d in range(n_dev):
            sel = a[dev == d]
            out[d, :len(sel)] = sel
        return out

    parts = {k: pad(ba[k]) for k in
             ("pos", "r0", "r1", "mv0", "mv1", "has1", "f0", "f1")}
    # dummies: scatter row -> guard (local row hl), harmless window gathers
    mask = np.zeros((n_dev, cap), bool)
    for d in range(n_dev):
        mask[d, :int((dev == d).sum())] = True
    parts["pos"][:, :, 0] = np.where(mask, parts["pos"][:, :, 0],
                                     (np.arange(n_dev)[:, None] + 1) * hl)
    parts["wp"] = (None if ba["wp"] is None
                   else [pad(a) for a in ba["wp"]])
    return parts


def mc_spatial(plan: FramePlan, refs: dict, mesh: Mesh,
               axis: str = "space") -> list | None:
    """MC prediction planes computed from a row-sharded DPB.

    Each device all_gathers the reference slabs it needs (DPB slab
    collective, SURVEY.md §2.3) and runs the separable 8/4-tap filters for
    the blocks in its row band.  Returns [3] numpy planes (host PCM stamp
    applied), bit-exact vs kernels.mc.build_inter_pred_device."""
    from p265_tpu.kernels.mc import stamp_pcm
    pcm_tus = [t for t in plan.tus if t.pcm]
    if not plan.pus and not pcm_tus:
        return None
    n_dev = mesh.shape[axis]
    sps = plan.sps
    w, h = sps.pic_width, sps.pic_height
    hls = [_block_rows(h, n_dev, 8), _block_rows(h >> 1, n_dev, 8)]
    poc_list, stacks = shard_refs(refs, mesh, axis,
                                  pad_rows=[hls[0] * n_dev,
                                            hls[1] * n_dev, hls[1] * n_dev])
    poc_index = {p: i for i, p in enumerate(poc_list)}
    out = []
    for c in range(3):
        shape = (h, w) if c == 0 else (h >> 1, w >> 1)
        ba = mc_block_arrays(plan, c, poc_index) if plan.pus else None
        if ba is None:
            out.append(np.zeros(shape, np.int32))
            continue
        hl = hls[min(c, 1)]
        parts = _partition_blocks(ba, hl, n_dev)
        block, taps = ba["block"], ba["taps"]
        n_refs = len(poc_list)

        def body(slabs, pos, r0, r1, mv0, mv1, has1, f0, f1, *wp):
            full = jax.lax.all_gather(slabs, axis, axis=1, tiled=True)
            rr0 = jax.lax.axis_index(axis) * hl
            p0 = _mc_blocks.__wrapped__(full, pos[0], r0[0], mv0[0], f0[0],
                                        block, taps, n_refs)
            p1 = _mc_blocks.__wrapped__(full, pos[0], r1[0], mv1[0], f1[0],
                                        block, taps, n_refs)
            wparams = tuple(a[0] for a in wp) if wp else None
            samp = _combine(p0, p1, has1[0], wparams)
            local = jnp.zeros((hl + block, shape[1]), jnp.int32)
            ly = pos[0][:, 0] - rr0
            rows = ly[:, None, None] + jnp.arange(block)[None, :, None]
            cols = (pos[0][:, 1][:, None, None]
                    + jnp.arange(block)[None, None, :])
            local = local.at[rows, cols].set(samp)
            return local[:hl][None]

        args = [stacks[c]] + [jnp.asarray(parts[k]) for k in
                              ("pos", "r0", "r1", "mv0", "mv1", "has1",
                               "f0", "f1")]
        if parts["wp"] is not None:
            args += [jnp.asarray(a) for a in parts["wp"]]
        specs = (P(None, axis, None),) + (P(axis),) * (len(args) - 1)
        fn = jax.shard_map(body, mesh=mesh, in_specs=specs,
                           out_specs=P(axis), check_vma=False)
        res = jax.jit(fn)(*args)
        out.append(np.asarray(res).reshape(-1, shape[1])[:shape[0]])
    stamp_pcm(plan, out)
    return out


# ---------------------------------------------------------------------------
# row-sharded deblocking (V pass local; H pass with a 4-row ppermute halo)
# ---------------------------------------------------------------------------


def _h_edge_params_per_device(glob, n_seg, hl, n_dev, H):
    """Distribute transposed-layout H-edge params [n_seg, n_e] (edges on the
    8-row grid of a plane of height H, i.e. rows 8, 16, .., H-8) into
    per-device [n_dev, n_seg, hl//8 + 1] slabs covering edge rows r0,
    r0+8, .., r0+hl (zeros = invalid edge = no filtering)."""
    pe = hl // 8 + 1
    out = np.zeros((n_dev, n_seg, pe), glob.dtype if glob.size else np.int32)
    for d in range(n_dev):
        for k in range(pe):
            row = d * hl + 8 * k
            # edge validity is delegated to the edge-param builder: glob
            # holds exactly the legal edges (8, 16, ..).  A "row <= H - 8"
            # gate here wrongly dropped the LAST chroma edge whenever the
            # plane height is not a multiple of 8 (e.g. 540 rows at 1080p:
            # edge 536 filters rows 535-536, entirely in-plane).
            if row >= 8 and row // 8 - 1 < glob.shape[1]:
                out[d, :, k] = glob[:, row // 8 - 1]
    return out


def _deblock_h_local(local, bs, beta, tc, hl, halo, axis):
    """H-pass deblock on a local row block: exchange `halo` rows both ways,
    zero-pad 8-halo rows on top so edges land on the kernel's 8k+8 grid, run
    the vertical kernel on the transpose, keep the owned rows."""
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    from_prev = jax.lax.ppermute(local[-halo:], axis, fwd)
    from_next = jax.lax.ppermute(local[:halo], axis, bwd)
    pw = local.shape[1]
    ext = jnp.concatenate([jnp.zeros((8 - halo, pw), local.dtype),
                           from_prev, local, from_next])
    filt = _deblock_luma_vertical.__wrapped__(ext.T, bs, beta, tc).T
    return filt[8:8 + hl]


def _deblock_h_chroma_local(local, tc, hl, halo, axis):
    n = jax.lax.axis_size(axis)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    from_prev = jax.lax.ppermute(local[-halo:], axis, fwd)
    from_next = jax.lax.ppermute(local[:halo], axis, bwd)
    pw = local.shape[1]
    ext = jnp.concatenate([jnp.zeros((8 - halo, pw), local.dtype),
                           from_prev, local, from_next])
    filt = _deblock_chroma_vertical.__wrapped__(ext.T, tc).T
    return filt[8:8 + hl]


def deblock_spatial(plan: FramePlan, planes: list, mesh: Mesh,
                    axis: str = "space") -> list:
    """Row-sharded deblocking: one shard_map dispatch filters all three
    planes (V pass local; H pass after a 4-row halo exchange of the
    V-filtered samples -- spec order, bit-exact vs kernels.deblock_tpu)."""
    n_dev = mesh.shape[axis]
    H, W = planes[0].shape
    Hc, Wc = planes[1].shape
    # pad row blocks onto the 8-row deblock grid; padded rows carry zeroed
    # edge params (no edge exists at row > H-8), so values there are inert
    hl, hc = _block_rows(H, n_dev, 8), _block_rows(Hc, n_dev, 8)

    bs_v, beta_v, tc_v = luma_edge_params(plan, vertical=True)
    tcb_v, tcr_v = chroma_edge_params(plan, vertical=True)
    bs_h, beta_h, tc_h = luma_edge_params(plan, vertical=False)
    tcb_h, tcr_h = chroma_edge_params(plan, vertical=False)
    # per-device H-pass edge slabs (owned edges + the shared boundary edge)
    bs_hd = _h_edge_params_per_device(bs_h, W // 4, hl, n_dev, H)
    beta_hd = _h_edge_params_per_device(beta_h, W // 4, hl, n_dev, H)
    tc_hd = _h_edge_params_per_device(tc_h, W // 4, hl, n_dev, H)
    # chroma H edges are on the chroma plane's own 8-row grid (16 luma rows)
    tcb_hd = _h_edge_params_per_device(tcb_h, Wc // 4, hc, n_dev, Hc)
    tcr_hd = _h_edge_params_per_device(tcr_h, Wc // 4, hc, n_dev, Hc)

    def body(y, cb, cr, bsv, betav, tcv, tcbv, tcrv,
             bsh, betah, tch, tcbh, tcrh):
        y, cb, cr = y[0], cb[0], cr[0]
        if bs_v.shape[1]:
            y = _deblock_luma_vertical.__wrapped__(y, bsv[0], betav[0],
                                                   tcv[0])
        if tcb_v.shape[1]:
            cb = _deblock_chroma_vertical.__wrapped__(cb, tcbv[0])
            cr = _deblock_chroma_vertical.__wrapped__(cr, tcrv[0])
        y = _deblock_h_local(y, bsh[0], betah[0], tch[0], hl, 4, axis)
        cb = _deblock_h_chroma_local(cb, tcbh[0], hc, 4, axis)
        cr = _deblock_h_chroma_local(cr, tcrh[0], hc, 4, axis)
        return y[None], cb[None], cr[None]

    def dev_split(a, rows):
        a = np.asarray(a)
        need = n_dev * rows
        if a.shape[0] < need:
            a = np.pad(a, ((0, need - a.shape[0]), (0, 0)))
        return jnp.asarray(a.reshape(n_dev, rows, -1))

    args = (dev_split(np.asarray(planes[0], np.int32), hl),
            dev_split(np.asarray(planes[1], np.int32), hc),
            dev_split(np.asarray(planes[2], np.int32), hc),
            dev_split(bs_v, hl // 4), dev_split(beta_v, hl // 4),
            dev_split(tc_v, hl // 4), dev_split(tcb_v, hc // 4),
            dev_split(tcr_v, hc // 4),
            jnp.asarray(bs_hd), jnp.asarray(beta_hd), jnp.asarray(tc_hd),
            jnp.asarray(tcb_hd), jnp.asarray(tcr_hd))
    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(axis),) * len(args),
                       out_specs=(P(axis),) * 3, check_vma=False)
    y, cb, cr = jax.jit(fn)(*args)
    return [np.asarray(y).reshape(-1, W)[:H],
            np.asarray(cb).reshape(-1, Wc)[:Hc],
            np.asarray(cr).reshape(-1, Wc)[:Hc]]


def loop_filters_spatial(plan: FramePlan, planes: list, mesh: Mesh,
                         axis: str = "space") -> list:
    """Full in-loop filter chain (deblock then SAO) row-sharded with halo
    exchange; bit-exact vs golden.apply_loop_filters."""
    from p265_tpu.golden.decoder import bypass_pixel_masks
    from p265_tpu.shard.filters import sao_sharded
    masks = bypass_pixel_masks(plan)
    orig = [np.asarray(p).copy() for p in planes] if masks else None
    out = [np.asarray(p, np.int32) for p in planes]
    if not plan.sh.deblocking_filter_disabled:
        out = deblock_spatial(plan, out, mesh, axis)
    if plan.sps.sao_enabled and (plan.sh.sao_luma or plan.sh.sao_chroma):
        out = sao_sharded(plan, out, mesh, axis)
    out = [np.asarray(p) for p in out]
    if masks:
        out = [np.where(m, o, p) for m, o, p in zip(masks, orig, out)]
    return out


def decode_picture_spatial(plan: FramePlan, refs: dict, mesh: Mesh,
                           axis: str = "space"):
    """One picture, Stage B fully sharded over mesh[axis]: sharded-DPB MC ->
    row-sharded wavefront recon -> halo deblock + SAO.

    Returns (prefilter, filtered) [y, cb, cr] numpy planes; bit-exact vs the
    unsharded golden/device path (tests/test_spatial.py)."""
    from p265_tpu.plan.frame_plan import build_tensor_plan
    pred = mc_spatial(plan, refs, mesh, axis)
    tplan = build_tensor_plan(plan, refs=None, pred_planes=pred)
    prefilter = reconstruct_spatial(tplan, mesh, axis)
    filtered = loop_filters_spatial(plan, prefilter, mesh, axis)
    return prefilter, filtered
