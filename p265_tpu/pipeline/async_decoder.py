"""Pipelined decoder: host Stage-A parse overlaps device Stage-B recon.

The parser thread runs ahead (it needs only syntax state -- including the
TMVP collocated-MV grids, which are complete at end of parse), submitting
reconstruction tasks to a single ordered worker.  The DecoderBase already
creates reference Picture shells at parse time; the worker fills their
planes strictly in decode order, so a dependent picture's MC always sees
finished references (SURVEY.md 7.1 stage overlap).

Tensorization (build_tensor_plan, host-heavy) also runs on the parse thread
-- shapes are syntax-pure -- so the worker does only MC + device dispatch.
The first calibrate_frames tasks are held back until the ShapePolicy has
seen them all, then released: one compiled program serves the stream.
"""
from __future__ import annotations

import copy
import queue
import threading

from p265_tpu.pipeline.decoder import TpuDecoder


class PipelinedTpuDecoder(TpuDecoder):
    """Three-stage pipeline: parse (caller thread) / pack+dispatch (recon
    worker) / d2h materialize (fetch worker).  Device execution is async
    behind the dispatch, so steady state runs all four resources --
    parse CPU, pack CPU, the device, and the d2h copy -- concurrently."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._worker = None
        self._worker_err = None
        self._warm_thread = None
        self._warm_err = None
        self._fetch_async = True

    def _ensure_worker(self):
        if self._worker is None:
            self._worker = threading.Thread(target=self._run_worker,
                                            daemon=True)
            self._worker.start()

    def _run_worker(self):
        while True:
            group = self._q.get()
            if group is None:
                return
            try:
                self._run_recon_group(group)
            except Exception as e:  # surfaced on flush
                self._worker_err = e
            finally:
                self._q.task_done()

    def _run_warm_compile(self, task: dict, policy) -> None:
        try:
            self._warm_compile(task, policy)
        except Exception as e:  # surfaced on flush
            self._warm_err = e

    def _schedule_recon(self, task: dict) -> None:
        task["tplan"] = self._build_tplan(task["plan"], skip_pred=True)
        self._ensure_worker()
        if self._recon_queue is not None:
            # calibration window: observe at parse time (the whole window
            # dispatches after one joint policy update)
            self.shape_policy.observe(task["tplan"],
                                      n_refs=len(task["refs"]))
            self._recon_queue.append(task)
            if len(self._recon_queue) >= self.calibrate_frames:
                held, self._recon_queue = self._recon_queue, None
                self._put_groups(held)
            return
        # post-window: do NOT observe here -- the parse thread races the
        # recon worker, so parse-time rung bumps made program shapes
        # depend on how far parse ran ahead (nondeterministic cache
        # misses; a 16-frame 1080p stream recompiled ~330 s run-over-run).
        # _build_batch's ladder calls grow the rungs at DISPATCH, in
        # decode order, deterministically.
        self._q.put([task])

    def _put_groups(self, tasks: list) -> None:
        from p265_tpu import compile_cache
        from p265_tpu.pipeline.decoder import plan_frame_groups
        groups = plan_frame_groups(tasks, self.frame_dag_max)
        # cold path: compile the first inter program (shapes only) on a
        # side thread while the worker's first dispatch compiles the intra
        # program (decoder._warm_compile; it pays off only through the
        # persistent cache).  The policy snapshot is taken here, before any
        # group is queued, so no thread races the worker.
        first_inter = next(
            (g[0] for g in groups[1:] if len(g) == 1 and g[0]["plan"].pus),
            None)
        if first_inter is not None and compile_cache.enabled():
            self._warm_thread = threading.Thread(
                target=self._run_warm_compile,
                args=(first_inter, copy.deepcopy(self.shape_policy)),
                daemon=True, name="p265-warm-compile")
            self._warm_thread.start()
        for g in groups:
            self._q.put(g)

    def _drain_recon(self, stop_deferring: bool = False) -> None:
        held, self._recon_queue = self._recon_queue, None
        self._put_groups(held or [])
        if self._worker is not None:
            self._q.join()
        if self._warm_thread is not None:
            # no compile outlives the stream that started it
            self._warm_thread.join()
            self._warm_thread = None
        err = self._worker_err or self._warm_err
        self._worker_err = self._warm_err = None
        if err is not None:
            raise err
        self._wait_fetches()
