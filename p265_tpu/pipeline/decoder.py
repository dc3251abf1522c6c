"""Device pipeline decoder: Stage A host parse -> Stage B device reconstruction.

Subclasses the shared DecoderBase (parsing, DPB, motion context) and routes
reconstruction + loop filters to the device kernels; bit-exact vs golden.

Per decoded picture the device work is ONE fused program (wavefront scan +
deblock + SAO + bypass restore) via pipeline/batch_decode with F=1, so a
picture costs one dispatch instead of one per filter stage.  Set
fused=False to fall back to per-stage device filters.
"""
from __future__ import annotations

import numpy as np

from p265_tpu.golden.decoder import DecoderBase, apply_loop_filters
from p265_tpu.plan.frame_plan import build_tensor_plan
from p265_tpu.syntax.ctu import FramePlan


def plan_frame_groups(tasks, max_f: int = 4) -> list:
    """Frame-DAG scheduler (SURVEY.md 2.3 'frame parallel'): partition a
    decode-order task list into groups of MUTUALLY INDEPENDENT inter
    pictures that can share ONE Stage-B dispatch on the batch axis --
    hierarchical-B siblings whose references all lie outside the group
    (e.g. testgen RA mini-GOPs decode 0,4,2 then batch {1,3}).

    A task joins the open group iff: it is an inter picture without PCM,
    same geometry and filter flags as the group, its DPB reference set
    contains no group member's POC, and the group stays within max_f.
    Groups preserve decode order, so every reference outside the group is
    already reconstructed when the group dispatches."""
    def fsig(p):
        return (p.sps, p.sh.deblocking_filter_disabled,
                p.sps.sao_enabled and p.sh.sao_luma,
                p.sps.sao_enabled and p.sh.sao_chroma)

    from p265_tpu.pipeline.wavefront import ShapePolicy

    def batchable(plan):
        return (ShapePolicy.kind_of(plan) == 1 and plan.pus
                and not getattr(plan, "_has_pcm", False))

    groups: list[list] = []
    cur: list = []
    for t in tasks:
        plan = t["plan"]
        if (cur and len(cur) < max_f and batchable(plan)
                and batchable(cur[0]["plan"])
                and fsig(plan) == fsig(cur[0]["plan"])
                and all(c["frame"].poc not in t["refs"] for c in cur)):
            cur.append(t)
            continue
        if cur:
            groups.append(cur)
        cur = [t]
    if cur:
        groups.append(cur)
    return groups


class TpuDecoder(DecoderBase):
    """Annex-B stream -> YUV frames via the device reconstruction path.

    One compile per stream (SURVEY.md 7.6): Stage-B tensor shapes are pure
    functions of the SYNTAX, never of reference pixels, so decode_stream
    tensorizes pictures at parse time, feeds every frame's shape needs into
    the ShapePolicy (calibration), and only then starts device work -- the
    whole stream then runs through a single compiled program.  The deferral
    window is bounded by calibrate_frames to cap host memory; frames past
    the window reconstruct immediately (the policy's running-max ladder
    absorbs any late growth with at most O(log) recompiles).
    """

    def __init__(self, use_mxu: bool = True, apply_filters: bool = True,
                 filters_on_device: bool = True, use_native_parse: bool = True,
                 fused: bool = True, shape_policy=None,
                 calibrate_frames: int = 8, frame_dag_max: int = 1):
        # frame_dag_max: >1 batches mutually independent inter pictures
        # (hierarchical-B siblings) into one dispatch.  Default OFF: batching
        # adds padding and a second set of compiles, and it has not been
        # shown to win on one device.
        super().__init__(apply_filters=apply_filters,
                         use_native_parse=use_native_parse)
        from p265_tpu.compile_cache import enable_persistent_cache
        enable_persistent_cache()
        self.use_mxu = use_mxu
        self._fetch_async = False       # PipelinedTpuDecoder turns this on
        self._fetch_exec = None
        self._fetch_futs: list = []
        self.filters_on_device = filters_on_device
        self.fused = fused and apply_filters and filters_on_device
        self._pending_filtered = None
        if shape_policy is None:
            from p265_tpu.pipeline.wavefront import ShapePolicy
            shape_policy = ShapePolicy()
        self.shape_policy = shape_policy
        self.calibrate_frames = calibrate_frames
        self.frame_dag_max = frame_dag_max if fused else 1
        self._recon_queue: list | None = None
        self.warm_program = None        # set by _warm_compile

    def decode_stream(self, data: bytes):
        if self.calibrate_frames and self._recon_queue is None:
            self._recon_queue = []
        try:
            return super().decode_stream(data)
        finally:
            self._recon_queue = None

    # -- recon scheduling: tensorize + calibrate at parse time ---------------
    def _build_tplan(self, plan: FramePlan, refs: dict | None = None,
                     skip_pred: bool = False):
        ns = getattr(plan, "nstate", None)
        if ns is not None:
            ns.finalize(plan)  # plan.sao must exist before filter packing
        return build_tensor_plan(plan, refs, device_mc=True,
                                 skip_pred=skip_pred)

    def _schedule_recon(self, task: dict) -> None:
        if self._recon_queue is None:
            return self._run_recon(task)
        task["tplan"] = self._build_tplan(task["plan"], skip_pred=True)
        self.shape_policy.observe(task["tplan"], n_refs=len(task["refs"]))
        self._recon_queue.append(task)
        if len(self._recon_queue) >= self.calibrate_frames:
            self._drain_recon(stop_deferring=True)

    def _drain_recon(self, stop_deferring: bool = False) -> None:
        q = self._recon_queue
        self._recon_queue = None if (stop_deferring or q is None) else []
        for group in plan_frame_groups(q or (), self.frame_dag_max):
            self._run_recon_group(group)

    def _run_recon(self, task: dict) -> None:
        """Fused path: one dispatch per picture; DPB slabs stay ON DEVICE
        (uint8), so the next picture's MC reads them with zero host round
        trips.  Host copies are made only for the output frames."""
        if not self.fused:
            return super()._run_recon(task)
        import time as _time
        plan, frame, pic = task["plan"], task["frame"], task["pic"]
        refs = {p: r.planes for p, r in task["refs"].items()}
        t1 = _time.perf_counter()
        tplan = task.get("tplan")
        if tplan is None:
            tplan = self._build_tplan(plan, skip_pred=True)
        from p265_tpu.pipeline.wavefront import ShapePolicy
        pol = self.shape_policy.profile(ShapePolicy.kind_of(plan))
        mc_in = refs_in = None
        mc_pad = 0
        if pol.want_mc and not getattr(plan, "_has_pcm", False):
            from p265_tpu.kernels.mc import (MC_PAD, mc_arrays_padded,
                                             mc_block_counts, mc_overreach)
            cnt = mc_block_counts(plan)
            poc_list = sorted(refs)
            mc_in = mc_arrays_padded(
                plan, {p: i for i, p in enumerate(poc_list)},
                {k: pol.mc_rows(k, n) for k, n in cnt.items()})
            refs_in = self._ref_stacks(refs, poc_list,
                                       pol.refs_cap(len(poc_list)))
            # contiguous-slice window fetch: exact while every window's
            # overreach fits the edge pad; rare big-MV frames fall back
            # to the per-element gather program (kernels/mc.py MC_PAD)
            mc_pad = MC_PAD if mc_overreach(plan) <= MC_PAD else 0
        elif getattr(plan, "_needs_pred", False) or pol.want_pred:
            from p265_tpu.plan.frame_plan import attach_pred_planes
            attach_pred_planes(tplan, refs)
        from p265_tpu.pipeline.batch_decode import decode_batch_planes
        pl, pc, fl, fc = decode_batch_planes(
            [tplan], [plan], use_mxu=self.use_mxu, policy=pol,
            mc=mc_in, refs=refs_in, stats=self.stats, mc_pad=mc_pad)
        pic.planes = [fl[0], fc[0], fc[1]]        # device uint8 DPB slabs
        pic.chroma_pair = fc                      # [2, Hc, Wc]: 1 d2h fetch
        t2 = _time.perf_counter()
        # prefilter planes stay ON DEVICE: only tests/debug tooling read
        # them; np.asarray()/np.array_equal on the device array fetches
        # lazily for consumers that do want the pixels.
        frame.prefilter = [pl[0], pc[0], pc[1]]
        if self._fetch_async:
            # materialize on the fetch worker: the d2h (which also absorbs
            # the wait for this frame's device execution) overlaps the NEXT
            # frame's pack + dispatch on this thread
            self._fetch_futs.append(
                self._fetch_executor().submit(self._materialize, frame, pic))
        else:
            frame.planes = self._fetch_planes(pic)
            self.stats["fetch_s"] = (self.stats.get("fetch_s", 0.0)
                                     + _time.perf_counter() - t2)
        self.stats["recon_s"] += _time.perf_counter() - t1

    def _run_recon_group(self, tasks: list) -> None:
        """Frame-DAG batch: F mutually independent inter pictures in ONE
        dispatch (plan_frame_groups).  Each frame keeps its own reference
        stacks and MC block arrays (per-frame program inputs); the merged
        tall plane carries all 3F segments through one scan + filter pass.
        Shapes come from the (1, F) policy profile so batch rungs never
        inflate the single-frame program."""
        if len(tasks) == 1 or not self.fused or not (
                self.shape_policy.profile(1).want_mc):
            for t in tasks:
                self._run_recon(t)
            return
        import time as _time
        t1 = _time.perf_counter()
        F = len(tasks)
        plans = [t["plan"] for t in tasks]
        tplans = []
        for t in tasks:
            tp = t.get("tplan")
            if tp is None:
                tp = self._build_tplan(t["plan"], skip_pred=True)
            tplans.append(tp)
        self.shape_policy.observe_group(
            tplans, [len(t["refs"]) for t in tasks])
        pol = self.shape_policy.profile((1, F))
        from p265_tpu.kernels.mc import (MC_PAD, mc_arrays_padded,
                                         mc_block_counts, mc_overreach)
        mc_list, refs_list = [], []
        mc_pad = MC_PAD
        for t, plan in zip(tasks, plans):
            refs = {p: r.planes for p, r in t["refs"].items()}
            poc_list = sorted(refs)
            mc_list.append(mc_arrays_padded(
                plan, {p: i for i, p in enumerate(poc_list)},
                {k: pol.mc_rows(k, n)
                 for k, n in mc_block_counts(plan).items()}))
            refs_list.append(self._ref_stacks(refs, poc_list,
                                              pol.refs_cap(len(poc_list))))
            if mc_overreach(plan) > MC_PAD:
                mc_pad = 0    # any big-MV frame: whole batch falls back
        from p265_tpu.pipeline.batch_decode import decode_batch_planes
        pl, pc, fl, fc = decode_batch_planes(
            tplans, plans, use_mxu=self.use_mxu, policy=pol,
            mc=mc_list, refs=tuple(refs_list), stats=self.stats,
            mc_pad=mc_pad)
        for f, t in enumerate(tasks):
            frame, pic = t["frame"], t["pic"]
            pic.planes = [fl[f], fc[f], fc[F + f]]
            frame.prefilter = [pl[f], pc[f], pc[F + f]]
            if self._fetch_async:
                self._fetch_futs.append(self._fetch_executor().submit(
                    self._materialize, frame, pic))
            else:
                frame.planes = [np.asarray(p, np.int32)
                                for p in pic.planes]
        self.stats["recon_s"] += _time.perf_counter() - t1
        self.stats["dag_batched"] = self.stats.get("dag_batched", 0) + F

    def _warm_compile(self, task: dict, policy) -> None:
        """Compile one inter task's Stage-B program ahead of its dispatch,
        from shapes only (.lower().compile(), nothing runs).

        PipelinedTpuDecoder runs this on a side thread for a stream's first
        inter picture while the recon worker's first dispatch compiles the
        intra program, so the two compiles overlap.  The executable reaches
        that later dispatch only through the persistent compile cache (jit
        dispatch does not reuse an ahead-of-time executable), so the thread
        starts only while the cache is on.  `policy` is a private snapshot
        of the shape policy: this thread never touches the shared one.
        A later stream of the same shapes lowers and compiles again; JAX's
        in-memory caches answer both without compiling, but the repack of
        one picture still costs host time (ROADMAP S9).

        Sets self.warm_program (the jax.stages.Compiled) and the
        `warm_compile_s` stat."""
        import time as _time

        import jax
        from p265_tpu.kernels.mc import (MC_PAD, mc_arrays_padded,
                                         mc_block_counts, mc_overreach)
        from p265_tpu.pipeline.batch_decode import (_build_batch,
                                                    _decode_batch_jit)
        from p265_tpu.pipeline.wavefront import ShapePolicy
        t0 = _time.perf_counter()
        plan, tplan = task["plan"], task["tplan"]
        pol = policy.profile(ShapePolicy.kind_of(plan))
        if not pol.want_mc or getattr(plan, "_has_pcm", False):
            return
        poc_list = sorted(task["refs"])
        n_refs = pol.refs_cap(len(poc_list))
        mc_in = mc_arrays_padded(
            plan, {p: i for i, p in enumerate(poc_list)},
            {k: pol.mc_rows(k, n) for k, n in mc_block_counts(plan).items()})
        mc_pad = MC_PAD if mc_overreach(plan) <= MC_PAD else 0
        bufs, meta = _build_batch([tplan], [plan], policy=pol, mc=[mc_in],
                                  mc_pad=mc_pad)
        h, w = plan.sps.pic_height, plan.sps.pic_width
        sds = jax.ShapeDtypeStruct
        refs_sds = (tuple(tuple(sds(shape, np.uint8) for _ in range(n_refs))
                          for shape in ((h, w), (h >> 1, w >> 1),
                                        (h >> 1, w >> 1))),)
        self.warm_program = _decode_batch_jit.lower(
            tuple(sds(b.shape, b.dtype) for b in bufs), meta, self.use_mxu,
            refs=refs_sds).compile()
        self.stats["warm_compile_s"] = _time.perf_counter() - t0

    def _fetch_executor(self):
        if self._fetch_exec is None:
            from concurrent.futures import ThreadPoolExecutor
            self._fetch_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="p265-fetch")
        return self._fetch_exec

    def _materialize(self, frame, pic) -> None:
        import time as _time
        t0 = _time.perf_counter()
        frame.planes = self._fetch_planes(pic)
        self.stats["fetch_s"] = (self.stats.get("fetch_s", 0.0)
                                 + _time.perf_counter() - t0)

    @staticmethod
    def _fetch_planes(pic) -> list:
        """Materialize a picture's planes with TWO device-to-host copies
        (luma + the [2, Hc, Wc] chroma pair) instead of three; on the H100
        the pair saves about 0.09 ms per 1080p picture (PERF.md)."""
        pair = getattr(pic, "chroma_pair", None)
        if pair is not None and pair.shape[0] == 2:
            y = np.asarray(pic.planes[0], np.int32)
            c = np.asarray(pair).astype(np.int32)
            return [y, c[0], c[1]]
        return [np.asarray(p, np.int32) for p in pic.planes]

    def _wait_fetches(self) -> None:
        futs, self._fetch_futs = self._fetch_futs, []
        for f in futs:
            f.result()   # re-raises fetch-side errors in decode order

    def _ref_stacks(self, refs: dict, poc_list: list, n_refs: int):
        """-> 3 tuples of n_refs device uint8 planes (y, cb, cr), padded by
        repetition (an IDR picture gets cached zero slabs)."""
        import jax.numpy as jnp
        pics = [refs[p] for p in poc_list]
        if not pics:
            sps = next(iter(self.sps_map.values()))
            shape = (sps.pic_height, sps.pic_width)
            if getattr(self, "_zero_slabs", (None,))[0] != shape:
                h, w = shape
                self._zero_slabs = (shape, [
                    jnp.zeros((h, w), jnp.uint8),
                    jnp.zeros((h >> 1, w >> 1), jnp.uint8),
                    jnp.zeros((h >> 1, w >> 1), jnp.uint8)])
            pics = [self._zero_slabs[1]]
        while len(pics) < n_refs:
            pics.append(pics[0])
        return tuple(tuple(jnp.asarray(p[c]).astype(jnp.uint8)
                           for p in pics) for c in range(3))

    def _reconstruct(self, plan: FramePlan, refs: dict,
                     tplan=None) -> list[np.ndarray]:
        if tplan is None:
            tplan = self._build_tplan(plan, refs)
        else:
            from p265_tpu.plan.frame_plan import attach_pred_planes
            attach_pred_planes(tplan, refs)
        if self.fused:
            from p265_tpu.pipeline.batch_decode import decode_batch_planes
            from p265_tpu.pipeline.wavefront import ShapePolicy
            pol = self.shape_policy.profile(ShapePolicy.kind_of(plan))
            pl, pc, fl, fc = decode_batch_planes([tplan], [plan],
                                                 use_mxu=self.use_mxu,
                                                 policy=pol)
            self._pending_filtered = [
                np.asarray(fl[0], np.int32), np.asarray(fc[0], np.int32),
                np.asarray(fc[1], np.int32)]
            return [np.asarray(pl[0], np.int32), np.asarray(pc[0], np.int32),
                    np.asarray(pc[1], np.int32)]
        from p265_tpu.pipeline.wavefront import reconstruct_tpu_scan
        return reconstruct_tpu_scan(tplan, self.use_mxu)

    def _filters(self, plan: FramePlan, planes: list[np.ndarray]):
        if self.fused and self._pending_filtered is not None:
            out = self._pending_filtered
            self._pending_filtered = None
            return out
        if self.filters_on_device:
            from p265_tpu.kernels.loopfilter import loop_filters_tpu
            return loop_filters_tpu(plan, planes)
        return apply_loop_filters(plan, planes)
