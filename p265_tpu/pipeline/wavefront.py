"""Device-resident wavefront executor: ONE lax.scan for the whole frame batch.

Architecture (host round trips cost far more than device scan steps):

- Host builds COMPACT per-TU arrays (step-ordered, int16/uint8/bool) plus a
  [n_steps, cap] gather map per size bucket.  No [n_steps, cap, ...] padding
  is materialized on the host -- that cost ~200 ms of numpy and 15 MB of
  upload per 4-frame batch.
- One jitted program takes the compact arrays, computes residuals
  (dequant+IDCT), expands everything to step-stacked form with device
  gathers, and runs the scan.  Zero host round trips inside.
- Outputs stay on device (callers fetch once, or feed the device-resident
  loop filters directly).

Luma and chroma planes of every frame in the batch are folded into ONE tall
plane buffer (per-plane segments of height h_i + GUARD, width = max w_i) and
decoded by a single scan: per-TU flags (filter_flag, strong_allowed, dc_edge)
make the kernel behave luma- or chroma-correctly per lane, so same-size TUs
of all planes share one size bucket and the sequential step count is the max
(not the sum) over planes.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from p265_tpu.kernels.intra import predict_values
from p265_tpu.kernels.intra_mxu import predict_values_mxu
from p265_tpu.kernels.itransform import batch_residual

USE_MXU_INTRA = True  # matmul-formulated intra predictor (kernels/intra_mxu)

from p265_tpu.plan.frame_plan import PlanePlan, TensorPlan, TuBatch

GUARD = 32


def _residual_for(b, log2: int, use_mxu: bool):
    """Residuals for a TuBatch."""
    sm = None if b.scale_m is None else jnp.asarray(b.scale_m)
    return batch_residual(
        jnp.asarray(b.coeffs), jnp.asarray(b.qp), jnp.asarray(b.is_dst),
        jnp.asarray(b.tskip), log2, use_mxu, bypass=jnp.asarray(b.bypass),
        scale_m=sm)


def _pow2(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


class ShapePolicy:
    """Quantizes Stage-B tensor shapes so a BOUNDED number of compiled
    programs serves a whole stream (SURVEY.md 7.6: "pad capacities chosen
    per level limits so recompilation never triggers mid-stream").

    Every shape knob (per-bucket lane capacity, per-bucket TU-row count,
    wavefront step count) is rounded up to a power of two and kept as a
    RUNNING MAX across frames: a frame never shrinks a shape, so the jit
    cache hits for every frame whose needs fit the current rung.  A frame
    that exceeds a rung bumps it once -- recompiles are bounded by the
    ladder height, not the stream length.  All four TU size buckets are
    always materialized (empty ones cost one pad lane).

    Shapes are kept PER FRAME KIND via profile(): intra pictures and
    inter pictures get separate ladders and hence separate programs.  Their
    wavefront geometries are opposite extremes -- a 1080p I frame runs
    ~1500 thin steps (<=64 lanes), a 1080p P frame ~100 fat steps (~1024
    lanes: intra islands over a step-1 inter sea).  One shared program
    would pay max(steps) x max(caps) = ~16x padding waste (measured 2.9 s
    vs 0.47 s scan at 1080p); two programs each stay near their true cost,
    and the intra program carries no MC/ITU machinery at all.  Stream-level
    flags (saw_pus, saw_bi, scaling, masks, refs) live on the root and are
    shared by all profiles.

    Lane caps and row counts use pow2 rungs only: padding is linear
    device compute, and fewer distinct shapes mean fewer compiles.  (A
    finer {pow2, 1.5*pow2} ladder once hit a compile-time cliff on another
    backend; whether it would pay under XLA:GPU is not measured.)
    """

    def __init__(self, want_pred: bool = False, _parent=None, _kind=None):
        self._caps: dict[int, int] = {}
        self._rows: dict[int, int] = {}
        self._steps = 8
        self._mc_rows: dict[str, int] = {}
        self._parent = _parent        # root policy (flag owner); None = root
        self._kind = _kind            # None = root; 0 = intra, 1 = inter
        self._profiles: dict[int, "ShapePolicy"] = {}
        self._n_refs = 1
        self._saw_pus = False         # any inter PU observed in the stream
        self._saw_bi = False          # any list-1 use: bi path in MC program
        self._saw_pcm = False         # PCM needs host-stamped pred planes
        self._want_pred = want_pred   # force the MC pred plane input
        self._want_scale = False      # force scale_m fields (scaling lists)
        self._want_masks = False      # force bypass-pixel mask inputs

    # -- stream-level flags: owned by the root, shared by profiles ----------
    def _root(self) -> "ShapePolicy":
        return self._parent or self

    def profile(self, kind: int) -> "ShapePolicy":
        """The shape profile for one frame kind (0 intra, 1 inter)."""
        root = self._root()
        p = root._profiles.get(kind)
        if p is None:
            p = ShapePolicy(_parent=root, _kind=kind)
            root._profiles[kind] = p
        return p

    def _flag(name):  # noqa: N805 -- descriptor factory, not a method
        def get(self):
            return getattr(self._root(), "_" + name)

        def set_(self, v):
            setattr(self._root(), "_" + name, v)
        return property(get, set_)

    saw_pcm = _flag("saw_pcm")
    want_scale = _flag("want_scale")
    want_masks = _flag("want_masks")
    del _flag

    @property
    def saw_pus(self) -> bool:
        # the intra profile's program never carries MC/ITU inputs
        if self._kind == 0:
            return False
        return self._root()._saw_pus

    @saw_pus.setter
    def saw_pus(self, v) -> None:
        self._root()._saw_pus = v

    @property
    def saw_bi(self) -> bool:
        if self._kind == 0:
            return False
        return self._root()._saw_bi

    @saw_bi.setter
    def saw_bi(self, v) -> None:
        self._root()._saw_bi = v

    @property
    def want_pred(self) -> bool:
        if self._kind == 0:
            return False
        return self._root()._want_pred

    @want_pred.setter
    def want_pred(self, v) -> None:
        self._root()._want_pred = v

    @property
    def want_mc(self) -> bool:
        """Use the fused-MC program (device-resident DPB slabs)?  PCM pixels
        are host-stamped into dense pred planes, so PCM streams keep the
        dense path."""
        return self.saw_pus and not self.saw_pcm

    @staticmethod
    def _ladder(n: int, lo: int = 8) -> int:
        return _pow2(n, lo=lo)

    def steps(self, needed: int) -> int:
        # steps is the scan TRIP COUNT: runtime scales linearly with it, so
        # quantize to a multiple (still stream-stable via running max)
        # rather than pow2 -- at 1080p real 1411 steps, pow2 pads to 2048
        # (+45% scan time) while 1536 costs +9%.  The quantum is adaptive:
        # P frames run short intra wavefronts (~83 steps at 1080p LDP)
        # where a flat 128 quantum wasted +54% of the scan (~90 ms/frame,
        # probe_inter_bisect r5); small counts quantize to 32.
        n = max(needed, 1)
        q = 32 if n <= 256 else 128
        self._steps = max(self._steps, _round_up(n, q))
        return self._steps

    def cap(self, log2: int, needed: int) -> int:
        cur = max(self._caps.get(log2, 8), self._ladder(max(needed, 1)))
        self._caps[log2] = cur
        return cur

    def rows(self, log2: int, needed: int) -> int:
        cur = max(self._rows.get(log2, 8), self._ladder(max(needed, 1)))
        self._rows[log2] = cur
        return cur

    def mc_rows(self, grp: str, needed: int) -> int:
        cur = max(self._mc_rows.get(grp, 8), self._ladder(max(needed, 1)))
        self._mc_rows[grp] = cur
        return cur

    def inter_rows(self, log2: int, needed: int) -> int:
        """Row rung of the hoisted inter-TU apply (separate key space from
        the scan buckets)."""
        key = f"i{log2}"
        cur = max(self._mc_rows.get(key, 8), self._ladder(max(needed, 1)))
        self._mc_rows[key] = cur
        return cur

    def refs_cap(self, needed: int) -> int:
        self._n_refs = max(self._n_refs, needed, 1)
        return self._n_refs

    # -- multi-process agreement (shard/distributed.py) ---------------------
    # Fixed-layout int vector of every shape knob, so N processes can
    # allgather + elementwise-max their policies and compile IDENTICAL
    # Stage-B programs (compile skew across hosts = deadlock on a real pod).
    _VEC_FLAGS = ("_saw_pus", "_saw_bi", "_saw_pcm", "_want_pred",
                  "_want_scale", "_want_masks")
    _VEC_LOG2 = (2, 3, 4, 5)
    _VEC_MC = ("y16", "y8", "y4", "c8", "c4", "c2", "i2", "i3", "i4", "i5")

    def state_vector(self) -> np.ndarray:
        """-> int64 vector [6 flags + 2 profiles x (steps, n_refs, 4 caps,
        4 rows, 10 mc_rows)] = 46 entries.  Zero = unobserved."""
        root = self._root()
        out = [int(getattr(root, f)) for f in self._VEC_FLAGS]
        for kind in (0, 1):
            p = root._profiles.get(kind) or ShapePolicy()
            out.append(p._steps)
            out.append(p._n_refs)
            out += [p._caps.get(l, 0) for l in self._VEC_LOG2]
            out += [p._rows.get(l, 0) for l in self._VEC_LOG2]
            out += [p._mc_rows.get(k, 0) for k in self._VEC_MC]
        return np.asarray(out, np.int64)

    def merge_state(self, vec) -> None:
        """Elementwise-max a state_vector into this policy (all entries are
        running maxima of ladder values, so max-merge is exact)."""
        root = self._root()
        vec = [int(v) for v in vec]
        for i, f in enumerate(self._VEC_FLAGS):
            if vec[i]:
                setattr(root, f, True)
        i = len(self._VEC_FLAGS)
        for kind in (0, 1):
            p = self.profile(kind)
            p._steps = max(p._steps, vec[i]); i += 1
            p._n_refs = max(p._n_refs, vec[i]); i += 1
            for l in self._VEC_LOG2:
                if vec[i]:
                    p._caps[l] = max(p._caps.get(l, 0), vec[i])
                i += 1
            for l in self._VEC_LOG2:
                if vec[i]:
                    p._rows[l] = max(p._rows.get(l, 0), vec[i])
                i += 1
            for k in self._VEC_MC:
                if vec[i]:
                    p._mc_rows[k] = max(p._mc_rows.get(k, 0), vec[i])
                i += 1

    @staticmethod
    def kind_of(fp) -> int:
        """Frame kind: 1 for pictures needing prediction machinery (inter
        PUs or PCM), 0 for pure intra."""
        return 1 if (fp.pus or getattr(fp, "_needs_pred", False)) else 0

    def observe(self, tplan, n_refs: int = 0) -> None:
        """Feed one frame's syntax-derived shape needs BEFORE any device
        dispatch.  The tplan may be built with skip_pred=True (shapes never
        depend on reference pixels), so a decoder can observe a whole stream
        at parse time and compile one program PER FRAME KIND for it.
        Mirrors the shape math of _merge_segments/_stack_plane/_build_batch
        for an F=1 batch: per bucket, lane cap = max TUs of all planes
        sharing a step, rows = total TUs + pad row."""
        fp = tplan.frame_plan
        self._feed(self.profile(self.kind_of(fp)), [tplan], [n_refs])

    def observe_group(self, tplans: list, n_refs_list: list) -> None:
        """Feed a FRAME-DAG GROUP (mutually independent frames batched into
        one Stage-B dispatch, e.g. hierarchical-B siblings): the group's
        merged plane sums per-step lane counts and TU rows across frames,
        so groups get their own profile keyed (1, F) -- batch rungs never
        inflate the single-frame program's shapes."""
        self._feed(self.profile((1, len(tplans))), tplans, n_refs_list)

    def _feed(self, prof, tplans: list, n_refs_list: list) -> None:
        from p265_tpu.plan.frame_plan import LOG2_SIZES
        pps_ = [pp for tp in tplans for pp in tp.planes]
        n_steps = max(pp.n_steps for pp in pps_)
        prof.steps(n_steps)
        for log2 in LOG2_SIZES:
            per_step = np.zeros(n_steps + 1, np.int64)
            rows = 1            # intra (scan) TUs; inter TUs are hoisted
            irows = 1
            for pp in pps_:
                b = pp.batches.get(log2)
                if b is None or len(b.step) == 0:
                    continue
                intra = ~np.asarray(b.inter)
                per_step += np.bincount(b.step[intra],
                                        minlength=n_steps + 1)[:n_steps + 1]
                rows += int(intra.sum())
                irows += int(len(b.step) - intra.sum())
                if b.scale_m is not None:
                    self.want_scale = True
            prof.cap(log2, int(per_step[1:].max()) if n_steps else 1)
            prof.rows(log2, rows)
            prof.inter_rows(log2, irows)
        from p265_tpu.golden.decoder import bypass_pixel_masks
        from p265_tpu.kernels.mc import mc_block_counts
        for tplan, n_refs in zip(tplans, n_refs_list):
            fp = tplan.frame_plan
            if getattr(fp, "_needs_pred", False) or any(
                    pp.inter_pred is not None for pp in tplan.planes):
                self.want_pred = True
            if bypass_pixel_masks(fp) is not None:
                self.want_masks = True
            if fp.pus:
                self.saw_pus = True
                if any(p.motion.uses(1) for p in fp.pus):
                    self.saw_bi = True
                for key, n in mc_block_counts(fp).items():
                    prof.mc_rows(key, n)   # per-frame inputs: max, not sum
            if any(t.pcm for t in fp.tus):
                self.saw_pcm = True
            prof.refs_cap(n_refs)
            self.profile(1).refs_cap(n_refs)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


_BOOL_FIELDS = ("ref_ok", "filter_flag", "strong_allowed", "inter", "dc_edge",
                "is_dst", "tskip", "bypass")


def _segments_of(pp: PlanePlan):
    offs = getattr(pp, "seg_offsets", None)
    if offs is None:
        return [0], [pp.shape[0]], [pp.shape[1]]
    return offs, pp.seg_heights, pp.seg_widths


def _stack_plane(pp: PlanePlan, policy=None):
    """Host: per-size COMPACT per-TU arrays + [n_steps, cap] gather maps.

    Every per-TU array carries one extra pad row at index n (scatters into
    the guard region / neutral values); idx_map points pad lanes there.
    Returns (n_steps, {log2: dict}) where each dict holds 'idx_map' plus the
    compact fields consumed by _run_plane_packed.  Cached on the PlanePlan.

    policy: optional ShapePolicy quantizing n_steps and per-bucket lane caps
    to stream-stable values (one compile per stream).
    """
    cached = getattr(pp, "_stacked_cache", None)
    if cached is not None and cached[0] is policy:
        return cached[1], cached[2]
    if policy is not None:
        n_steps = policy.steps(pp.n_steps)
    else:
        n_steps = _round_up(max(pp.n_steps, 1), 8)
    ph, pw = pp.shape
    coord_dt = np.uint16 if max(ph + GUARD, pw) < 65000 else np.int32
    out = {}
    for log2, b in pp.batches.items():
        counts = np.bincount(b.step, minlength=n_steps + 1)[1:n_steps + 1]
        max_cnt = int(counts.max()) if counts.size else 1
        cap = (policy.cap(log2, max_cnt) if policy is not None
               else _pow2(max_cnt))
        n = len(b.step)
        # lane l of step-row s holds starts[s]+l while < starts[s+1]; else n
        starts = np.searchsorted(b.step, np.arange(1, n_steps + 2))
        lane = np.arange(cap)[None, :]
        idx_map = starts[:n_steps, None] + lane
        idx_map = np.where(idx_map < starts[1:n_steps + 1, None], idx_map, n)

        def padded(a, fill, dt):
            return np.concatenate(
                [a, np.full((1,) + a.shape[1:], fill, a.dtype)]).astype(dt)

        d = dict(
            counts=(starts[1:n_steps + 1]
                    - starts[:n_steps]).astype(np.int32),
            idx_map=idx_map.astype(np.int32),
            pos=padded(b.pos, 0, coord_dt),
            ref_ys=padded(b.ref_ys, 0, coord_dt),
            ref_xs=padded(b.ref_xs, 0, coord_dt),
            ref_ok=padded(b.ref_ok, False, bool),
            mode=padded(b.mode, 1, np.uint8),
            filter_flag=padded(b.filter_flag, False, bool),
            strong_allowed=padded(b.strong_allowed, False, bool),
            inter=padded(b.inter, False, bool),
            dc_edge=padded(b.dc_edge, False, bool),
            coeffs=padded(b.coeffs, 0, np.int16),
            qp=padded(b.qp, 0, np.uint8),
            is_dst=padded(b.is_dst, False, bool),
            tskip=padded(b.tskip, False, bool),
            bypass=padded(b.bypass, False, bool),
        )
        d["pos"][n] = (ph, 0)  # pad TUs scatter into the guard region
        if b.scale_m is not None:
            d["scale_m"] = padded(b.scale_m, 16, np.uint8)
        out[log2] = d
    pp._stacked_cache = (policy, n_steps, out)
    return n_steps, out


def _expand(tu, idx_maps, sizes, use_mxu):
    """Device: compact per-TU arrays -> step-stacked scan inputs."""
    stacked = {}
    for log2 in sizes:
        d = tu[log2]
        im = idx_maps[log2]
        sm = d.get("scale_m")
        res = batch_residual.__wrapped__(
            d["coeffs"].astype(jnp.int32), d["qp"].astype(jnp.int32),
            d["is_dst"], d["tskip"], log2, use_mxu, bypass=d["bypass"],
            scale_m=None if sm is None else sm.astype(jnp.int32))
        stacked[log2] = dict(
            pos=d["pos"].astype(jnp.int32)[im],
            ref_ys=d["ref_ys"].astype(jnp.int32)[im],
            ref_xs=d["ref_xs"].astype(jnp.int32)[im],
            ref_ok=d["ref_ok"][im],
            mode=d["mode"].astype(jnp.int32)[im],
            filter_flag=d["filter_flag"][im],
            strong_allowed=d["strong_allowed"][im],
            inter=d["inter"][im],
            dc_edge=d["dc_edge"][im],
            residual=res[im],
        )
    return stacked


@functools.partial(jax.jit,
                   static_argnames=("sizes", "c_idx", "shape", "use_mxu"))
def _run_plane_packed(tu, idx_maps, sizes: tuple, c_idx: int, shape: tuple,
                      pred_plane=None, use_mxu: bool = True):
    """Compact per-TU inputs -> reconstructed plane, all on device."""
    stacked = _expand(tu, idx_maps, sizes, use_mxu)
    return _scan_plane(stacked, sizes, c_idx, shape, pred_plane)


def _scan_plane(stacked, sizes, c_idx, shape, pred_plane, init_plane=None):
    ph, pw = shape
    if init_plane is None:
        plane = jnp.zeros((ph + GUARD, pw), jnp.int32)
    else:
        plane = init_plane
    has_inter = pred_plane is not None
    if pred_plane is None:
        pred_pad = jnp.zeros((1, 1), jnp.int32)
    else:
        pred_pad = jnp.zeros((ph + GUARD, pw), jnp.int32)
        pred_pad = pred_pad.at[:ph, :pw].set(pred_plane[:ph, :pw])

    def body(plane, step_data):
        # TUs of one wavefront step are independent across size buckets
        # (step = 1 + max producer step), so every bucket predicts from the
        # SAME pre-step plane and all blocks land in ONE flat scatter --
        # the scatter is the dominant per-step cost at 1080p and merging
        # cuts the chained-scatter count 4x (probe_scan_variants.py:
        # 942 ms -> 465 ms for a 1080p intra frame).
        pred_fn = (predict_values_mxu if USE_MXU_INTRA else predict_values)
        pw = plane.shape[1]
        flat_idx, flat_val = [], []
        for log2 in sizes:
            d = step_data[log2]
            rows, cols, out = pred_fn.__wrapped__(
                plane, d["pos"], d["ref_ys"], d["ref_xs"], d["ref_ok"],
                d["mode"], d["filter_flag"], d["strong_allowed"],
                d["residual"], 1 << log2, c_idx,
                inter=d["inter"] if has_inter else None,
                pred_plane=pred_pad if has_inter else None,
                dc_edge=d["dc_edge"])
            flat_idx.append((rows * pw + cols).reshape(-1))
            flat_val.append(out.reshape(-1))
        plane = plane.reshape(-1).at[jnp.concatenate(flat_idx)].set(
            jnp.concatenate(flat_val)).reshape(plane.shape)
        return plane, None

    plane, _ = jax.lax.scan(body, plane, stacked)
    return plane[:ph]


# legacy entry point used by shard/decoder.py: stacked tensors already built
@functools.partial(jax.jit, static_argnames=("sizes", "c_idx", "shape"))
def _run_plane(stacked, residuals, sizes: tuple, c_idx: int, shape: tuple,
               pred_plane=None):
    merged = {log2: dict(stacked[log2], residual=residuals[log2])
              for log2 in sizes}
    return _scan_plane(merged, sizes, c_idx, shape, pred_plane)


# ---------------------------------------------------------------------------
# unified merged execution: all planes of all frames fold into one tall plane
# (per-plane segments of height h_i + GUARD), decoded by ONE scan.  Per-TU
# flags keep luma/chroma semantics; same-size TUs share buckets.
# ---------------------------------------------------------------------------


def _empty_tu_batch(log2: int, with_scale: bool) -> TuBatch:
    """Zero-TU bucket so a stream-stable program always sees all sizes."""
    s = 1 << log2
    nref2 = 2 * (2 * s + 1)
    zb = np.zeros(0, bool)
    zi = np.zeros(0, np.int32)
    return TuBatch(
        size=s, pos=np.zeros((0, 2), np.int32), step=zi,
        coeffs=np.zeros((0, s, s), np.int32), qp=zi, mode=zi, c_idx=zi,
        is_dst=zb, tskip=zb, has_res=zb, bypass=zb,
        scale_m=(np.zeros((0, s, s), np.int32) if with_scale else None),
        inter=zb, filter_flag=zb, strong_allowed=zb, dc_edge=zb,
        ref_ys=np.zeros((0, nref2), np.int32),
        ref_xs=np.zeros((0, nref2), np.int32),
        ref_ok=np.zeros((0, nref2), bool),
        ok_scan=np.zeros((0, 4 * s + 1), bool))


def _merge_segments(pps_: list, policy=None, host_pred: bool = True):
    """Fold PlanePlans of arbitrary shapes into one tall plane.

    Returns (merged PlanePlan, [offset per input]).  With a ShapePolicy,
    all LOG2_SIZES buckets are materialized (empty ones as zero-TU batches)
    so the bucket set -- and hence the compiled program -- is stream-stable.
    host_pred=False: skip materializing the dense prediction plane (the
    fused-MC program computes it on device).
    """
    heights = [pp.shape[0] for pp in pps_]
    widths = [pp.shape[1] for pp in pps_]
    pw = max(widths)
    offs = []
    off = 0
    for h in heights:
        offs.append(off)
        off += h + GUARD
    total_h = off - GUARD
    n_steps = max(pp.n_steps for pp in pps_)
    merged = PlanePlan(0, (total_h, pw), n_steps)
    merged.seg_offsets = list(offs)
    merged.seg_heights = list(heights)
    merged.seg_widths = list(widths)
    force_scale = policy is not None and policy.want_scale
    all_sizes = sorted({log2 for pp in pps_ for log2 in pp.batches})
    for log2 in all_sizes:
        parts = []
        for pp, off in zip(pps_, offs):
            b = pp.batches.get(log2)
            if b is None:
                continue
            pos = b.pos.copy()
            pos[:, 0] += off
            rys = b.ref_ys + off  # invalid refs are gated by ref_ok
            parts.append((b, pos, rys))
        if not parts:
            continue
        order = np.argsort(
            np.concatenate([b.step for b, _, _ in parts]), kind="stable")
        cat = lambda key: np.concatenate(
            [getattr(b, key) for b, _, _ in parts])[order]
        merged.batches[log2] = TuBatch(
            size=1 << log2,
            pos=np.concatenate([p for _, p, _ in parts])[order],
            step=cat("step"),
            coeffs=cat("coeffs"),
            qp=cat("qp"),
            mode=cat("mode"),
            c_idx=cat("c_idx"),
            is_dst=cat("is_dst"),
            tskip=cat("tskip"),
            has_res=cat("has_res"),
            bypass=cat("bypass"),
            scale_m=(None if not force_scale
                     and all(b.scale_m is None for b, _, _ in parts)
                     else np.concatenate(
                         [b.scale_m if b.scale_m is not None
                          else np.full((len(b.step), 1 << log2, 1 << log2),
                                       16, np.int32)
                          for b, _, _ in parts])[order]),
            inter=cat("inter"),
            filter_flag=cat("filter_flag"),
            strong_allowed=cat("strong_allowed"),
            dc_edge=cat("dc_edge"),
            ref_ys=np.concatenate([r for _, _, r in parts])[order],
            ref_xs=cat("ref_xs"),
            ref_ok=cat("ref_ok"),
            ok_scan=cat("ok_scan"),
        )
    if policy is not None:
        from p265_tpu.plan.frame_plan import LOG2_SIZES
        with_scale = force_scale or any(b.scale_m is not None
                                        for pp in pps_ for b in pp.batches.values())
        for log2 in LOG2_SIZES:
            if log2 not in merged.batches:
                merged.batches[log2] = _empty_tu_batch(log2, with_scale)
    preds = None
    if host_pred and ((policy is not None and policy.want_pred) or any(
            pp.inter_pred is not None for pp in pps_)):
        preds = np.zeros((total_h, pw), np.int32)
        for pp, off in zip(pps_, offs):
            if pp.inter_pred is not None:
                h, w = pp.shape
                preds[off:off + h, :w] = pp.inter_pred
    merged.inter_pred = preds
    return merged, offs


def reconstruct_tpu_scan_plane(pp, use_mxu: bool = True):
    """Run the scan for a single PlanePlan; returns the DEVICE plane [shape]."""
    n_steps, stacked = _stack_plane(pp)
    tu = {log2: {k: v for k, v in d.items() if k != "idx_map"}
          for log2, d in stacked.items()}
    idx_maps = {log2: d["idx_map"] for log2, d in stacked.items()}
    sizes = tuple(sorted(pp.batches.keys()))
    pred = (None if pp.inter_pred is None else jnp.asarray(pp.inter_pred))
    return _run_plane_packed(tu, idx_maps, sizes, min(pp.plane_idx, 1),
                             pp.shape, pred, use_mxu)


def _reconstruct_merged(pps_: list, use_mxu: bool):
    """One scan over merged segments -> list of DEVICE planes (input order)."""
    merged, offs = _merge_segments(pps_)
    if not merged.batches:
        return [jnp.zeros(pp.shape, jnp.int32) for pp in pps_]
    plane = reconstruct_tpu_scan_plane(merged, use_mxu)
    return [plane[off:off + pp.shape[0], :pp.shape[1]]
            for pp, off in zip(pps_, offs)]


def reconstruct_tpu_scan(tplan: TensorPlan, use_mxu: bool = True):
    """Stage B via one merged scan; returns [y, cb, cr] device planes."""
    return _reconstruct_merged(tplan.planes, use_mxu)


def reconstruct_tpu_scan_frames(tplans: list, use_mxu: bool = True):
    """Batched Stage B over F frames -> list of [y, cb, cr] per frame.

    Frames may have different resolutions; all 3F planes run in one scan."""
    pps_ = [pp for tp in tplans for pp in tp.planes]
    flat = _reconstruct_merged(pps_, use_mxu)
    return [flat[3 * f:3 * f + 3] for f in range(len(tplans))]
