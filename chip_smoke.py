"""Smoke test of the decoder on NVIDIA GPUs, through its normal entry points.

    python chip_smoke.py          # one card: device, kernels, decode phases
    python chip_smoke.py --four   # four cards: the sharded `stream` and
                                  # `space` meshes vs the golden decoder only

One process drives every card; it starts no other JAX process.  Each phase
prints its lines as it goes.  Any failure raises and the script exits non-zero
before the last line, which is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Every comparison is exact (np.array_equal).  Zero tolerance is right: every
matrix product in the decoder multiplies bounded integers whose bf16 operands
hold at most 8 significant bits and whose f32 partial sums stay below 2^24,
which is exact under any summation order and under TF32.

Times are printed for information; they are not benchmark results.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

from p265_tpu.device import parse_smi, require_gpu, smi_line

BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"

# 1080p bucket sizes for the standalone kernel checks: TU rows per transform
# size, lanes per wavefront step, MC blocks per bucket
RESIDUAL_ROWS = {2: 8192, 3: 4096, 4: 2048, 5: 512}
INTRA_LANES = 64
MC_BLOCKS = {(16, 8): 4096, (8, 8): 2048, (4, 8): 2048,
             (8, 4): 4096, (4, 4): 2048, (2, 4): 2048}
PLANE_H, PLANE_W = 1080, 1920


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def result_line(devs: list) -> str:
    d = devs[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}})


def best_ms(fn, reps: int = 10) -> float:
    """Best wall time of fn() (which must block until the device is done)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def assert_equal(what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.argwhere(got != want)[:3].tolist()
               if got.shape == want.shape else "shape")
        raise AssertionError(f"{what}: differs from the reference "
                             f"(shapes {got.shape} vs {want.shape}; "
                             f"first mismatches {bad})")


class CompileCounter:
    """Counts XLA compiles (persistent-cache loads included) in a window."""

    def __init__(self):
        import jax
        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event == BACKEND_COMPILE_EVENT:
            self.n += 1


# ---------------------------------------------------------------------------
# phase: device
# ---------------------------------------------------------------------------


def phase_device(devs: list) -> str:
    import jax
    from p265_tpu import compile_cache, native
    compile_cache.enable_persistent_cache()
    d = devs[0]
    log("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(devs)}")
    smi = smi_line()
    name, limit = parse_smi(smi)
    log("device", f"nvidia-smi: name={name} power.limit={limit}")
    log("device", f"jax {jax.__version__}; compile cache "
                  f"{compile_cache.cache_dir()}")
    if not native.available():
        raise RuntimeError("the native C Stage-A lane did not build: "
                           f"{native.build_error()}")
    log("device", "native C Stage-A lane: built and loaded")
    return smi


# ---------------------------------------------------------------------------
# phase: kernels (each Stage-B kernel alone, 1080p bucket shapes, vs oracle)
# ---------------------------------------------------------------------------


def check_residual(rng) -> None:
    import jax
    import jax.numpy as jnp
    from p265_tpu.golden.transform import (batch_residual_reference,
                                           random_tu_batch)
    from p265_tpu.kernels.itransform import batch_residual
    for log2, n in RESIDUAL_ROWS.items():
        case = random_tu_batch(rng, log2, n)
        want = batch_residual_reference(*case, log2)
        lv, qp, dst, ts, byp = (jnp.asarray(a) for a in case)
        times = {}
        for use_mxu in (True, False):
            def run():
                return jax.block_until_ready(batch_residual(
                    lv, qp, dst, ts, log2, use_mxu, bypass=byp))
            assert_equal(f"batch_residual log2={log2} use_mxu={use_mxu}",
                         run(), want)
            times["limb" if use_mxu else "int32"] = best_ms(run)
        log("kernels", f"batch_residual {1 << log2}x{1 << log2} n={n}: "
                       f"exact (both paths); limb {times['limb']:.3f} ms, "
                       f"int32 {times['int32']:.3f} ms")


def intra_case(rng, s: int, n: int, plane_h: int, plane_w: int):
    nref2 = 2 * (2 * s + 1)
    pos = np.stack([rng.integers(0, (plane_h - s) // 4, n) * 4,
                    rng.integers(0, (plane_w - s) // 4, n) * 4],
                   1).astype(np.int32)
    ref_ys = rng.integers(0, plane_h, (n, nref2)).astype(np.int32)
    ref_xs = rng.integers(0, plane_w, (n, nref2)).astype(np.int32)
    ok = rng.random((n, nref2)) < 0.8
    mode = rng.integers(0, 35, n).astype(np.int32)
    ff = np.array([m not in (0, 1, 10, 26) for m in mode]) & (s > 4)
    strong = rng.integers(0, 2, n).astype(bool) & (s == 32)
    res = rng.integers(-64, 64, (n, s, s)).astype(np.int32)
    dc_edge = rng.random(n) < 0.9
    return pos, ref_ys, ref_xs, ok, mode, ff, strong, res, dc_edge


def check_intra(rng) -> None:
    import jax
    import jax.numpy as jnp
    from p265_tpu.kernels.intra import predict_values
    from p265_tpu.kernels.intra_mxu import predict_values_mxu
    from p265_tpu.pipeline.wavefront import GUARD
    plane = jnp.asarray(rng.integers(0, 256, (PLANE_H + GUARD, PLANE_W)),
                        jnp.int32)
    for s in (4, 8, 16, 32):
        for c_idx in (0, 1):
            *args, dc_edge = (jnp.asarray(a) for a in intra_case(
                rng, s, INTRA_LANES, PLANE_H, PLANE_W))
            outs = {}
            for name, fn in (("matmul", predict_values_mxu),
                             ("reference", predict_values)):
                def run(fn=fn):
                    return jax.block_until_ready(
                        fn(plane, *args, s, c_idx, dc_edge=dc_edge))
                outs[name] = (run(), best_ms(run))
            for k, part in enumerate(("rows", "cols", "samples")):
                assert_equal(f"predict_values_mxu {s}x{s} c_idx={c_idx} "
                             f"{part}", outs["matmul"][0][k],
                             outs["reference"][0][k])
            log("kernels", f"predict_values_mxu {s}x{s} c_idx={c_idx} "
                           f"n={INTRA_LANES}: exact; matmul "
                           f"{outs['matmul'][1]:.3f} ms, reference "
                           f"{outs['reference'][1]:.3f} ms")


def check_mc(rng) -> None:
    import jax
    import jax.numpy as jnp
    from p265_tpu.golden import inter as gi
    from p265_tpu.kernels.mc import MC_PAD, _mc_blocks
    from p265_tpu.tables import CHROMA_FILTER, LUMA_FILTER
    n_refs = 2
    for (block, taps), n in MC_BLOCKS.items():
        h, w = ((PLANE_H, PLANE_W) if taps == 8
                else (PLANE_H >> 1, PLANE_W >> 1))
        refs_np = rng.integers(0, 256, (n_refs, h, w)).astype(np.int32)
        filt = np.asarray(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                          np.int32)
        fmask = 3 if taps == 8 else 7
        pos = np.stack([rng.integers(0, h // block, n) * block,
                        rng.integers(0, w // block, n) * block],
                       1).astype(np.int32)
        # MVs up to +-8 px: windows also reach past the picture edge
        mv = rng.integers(-8 * (fmask + 1), 8 * (fmask + 1),
                          (n, 2)).astype(np.int32)
        ridx = rng.integers(0, n_refs, n).astype(np.int32)
        ff = np.stack([filt[mv[:, 0] & fmask], filt[mv[:, 1] & fmask]], 1)
        mc_fn = gi.mc_luma if taps == 8 else gi.mc_chroma
        want = np.stack([
            mc_fn(refs_np[ridx[i]], int(pos[i, 1]), int(pos[i, 0]), block,
                  block, int(mv[i, 0]), int(mv[i, 1])) for i in range(n)])
        refs = jnp.asarray(refs_np)
        refs_pad = jnp.pad(refs, ((0, 0), (MC_PAD, MC_PAD),
                                  (MC_PAD, MC_PAD)), mode="edge")
        args = [jnp.asarray(a) for a in (pos, ridx, mv, ff)]
        times = {}
        for name, r, pad in (("gather", refs, 0),
                             ("slice", refs_pad, MC_PAD)):
            def run(r=r, pad=pad):
                return jax.block_until_ready(_mc_blocks(
                    r, *args, block, taps, n_refs, slice_pad=pad))
            assert_equal(f"_mc_blocks {block}x{block} taps={taps} {name}",
                         run(), want)
            times[name] = best_ms(run)
        log("kernels", f"_mc_blocks {block}x{block} taps={taps} n={n}: "
                       f"exact; gather {times['gather']:.3f} ms, slice "
                       f"{times['slice']:.3f} ms")


def check_filters(frame) -> None:
    """The Stage-B program's deblock+SAO stage on one decoded picture."""
    import jax
    import jax.numpy as jnp
    from p265_tpu.golden.decoder import apply_loop_filters
    from p265_tpu.pipeline.batch_decode import (filter_params,
                                                loop_filter_planes)
    plan = frame.plan
    grids, deblock, sao_luma, sao_chroma = filter_params([plan])
    grids = {k: jnp.asarray(v) for k, v in grids.items()}
    luma = jnp.asarray(np.asarray(frame.prefilter[0], np.int32)[None])
    chroma = jnp.asarray(np.stack([np.asarray(frame.prefilter[c], np.int32)
                                   for c in (1, 2)]))
    filt = jax.jit(loop_filter_planes, static_argnums=(3, 4, 5, 6))

    def run():
        return jax.block_until_ready(filt(
            luma, chroma, grids, deblock, sao_luma, sao_chroma,
            plan.sps.ctb_size))
    want = apply_loop_filters(plan, [np.asarray(p, np.int32)
                                     for p in frame.prefilter])
    y, c = run()
    for k, got in enumerate((y[0], c[0], c[1])):
        assert_equal(f"deblock+SAO plane {k}", got, want[k])
    log("kernels", f"deblock+SAO {plan.sps.pic_width}x"
                   f"{plan.sps.pic_height} (deblock={deblock}, "
                   f"sao={sao_luma}/{sao_chroma}): exact vs "
                   f"golden; {best_ms(run):.3f} ms")


def phase_kernels(p_frame) -> None:
    rng = np.random.default_rng(2024)
    check_residual(rng)
    check_intra(rng)
    check_mc(rng)
    check_filters(p_frame)


# ---------------------------------------------------------------------------
# phase: decode (production entry points vs the golden decoder)
# ---------------------------------------------------------------------------


def gate(what: str, frames, gold) -> None:
    if len(frames) != len(gold):
        raise AssertionError(f"{what}: {len(frames)} frames, golden "
                             f"{len(gold)}")
    for f, g in zip(frames, gold):
        for c in range(3):
            assert_equal(f"{what} poc {g.poc} plane {c}", f.planes[c],
                         g.planes[c])


def _stats(dec) -> str:
    return json.dumps({k: round(v, 4) for k, v in dec.stats.items()
                       if isinstance(v, float)})


def _steps(dec) -> str:
    prof = dec.shape_policy._root()._profiles
    return ", ".join(f"{'intra' if k == 0 else 'inter'} {p._steps}"
                     for k, p in sorted(prof.items(), key=str))


def decode_stream_timed(name: str, data: bytes, gold, smi: str,
                        counter: CompileCounter):
    """Cold decode, then best of 3 warm ones, each gated bit-exact.
    -> the cold decode's ahead-of-time compiled inter program, or None."""
    import gc
    from p265_tpu.pipeline.async_decoder import PipelinedTpuDecoder
    t0 = time.perf_counter()
    dec = PipelinedTpuDecoder()
    frames = dec.decode_stream(data)
    cold = time.perf_counter() - t0
    gate(f"{name} (PipelinedTpuDecoder)", frames, gold)
    log("decode", f"{name}: {len(frames)} frames bit-exact vs golden; cold "
                  f"{cold:.3f} s; stats {_stats(dec)}")
    warm_program = dec.warm_program
    del frames, dec
    warm = []
    for _ in range(3):
        gc.collect()
        n0 = counter.n
        dec = PipelinedTpuDecoder()
        t0 = time.perf_counter()
        frames = dec.decode_stream(data)
        warm.append(time.perf_counter() - t0)
        compiles = counter.n - n0
        gate(f"{name} warm", frames, gold)
        if compiles:
            raise AssertionError(f"{name}: a warm decode compiled "
                                 f"{compiles} programs")
        del frames
    log("decode", f"{name}: warm best of 3 {min(warm):.3f} s "
                  f"(runs {', '.join(f'{t:.3f}' for t in warm)}; 0 compiles); "
                  f"stats {_stats(dec)}; scan steps {_steps(dec)}; card "
                  f"{smi}")
    return warm_program


def phase_decode(smi: str, golds: dict, counter: CompileCounter) -> None:
    from p265_tpu import cli, compile_cache, yuv
    from tools.make_streams import get_stream, stream_path
    prog = decode_stream_timed("s1080_ldp4", get_stream("s1080_ldp4"),
                               golds["s1080_ldp4"], smi, counter)
    if prog is None:
        raise AssertionError("s1080_ldp4: the cold decode compiled no inter "
                             "program ahead of its dispatch")
    ma = prog.memory_analysis()
    log("decode", "s1080_ldp4 inter Stage-B program (compiled ahead of its "
                  "dispatch) memory: "
                  + ", ".join(f"{k}={getattr(ma, k)}" for k in (
                      "argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes", "generated_code_size_in_bytes")
                      if hasattr(ma, k)))
    del prog
    decode_stream_timed("s1080", get_stream("s1080"), golds["s1080"], smi,
                        counter)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["decode", "-i", stream_path("s1080_ldp4"), "--md5"])
    text = out.getvalue()
    md5 = next((ln.split()[1] for ln in text.splitlines()
                if ln.startswith("MD5:")), None)
    want = yuv.sequence_md5([[np.clip(p, 0, 255) for p in g.cropped_planes()]
                             for g in golds["s1080_ldp4"]])
    if rc != 0 or md5 != want:
        raise AssertionError(f"cli decode: rc {rc}, md5 {md5}, golden "
                             f"{want}; output {text!r}")
    log("decode", f"s1080_ldp4 via `p265_tpu.cli decode --md5`: md5 {md5} "
                  f"== golden")
    cdir = compile_cache.cache_dir()
    n = len(os.listdir(cdir)) if os.path.isdir(cdir) else 0
    log("decode", f"compile cache {cdir}: {n} entries")


# ---------------------------------------------------------------------------
# phase: four cards (sharded stream and space meshes)
# ---------------------------------------------------------------------------

FOUR_STREAMS = ("s1080", "s1080_i0", "s1080_i1", "s1080_i2")


def phase_four(devs: list, golds: dict) -> None:
    from jax.sharding import Mesh
    from p265_tpu.plan.frame_plan import build_tensor_plan
    from p265_tpu.shard.decoder import sharded_multistream_recon
    from p265_tpu.shard.spatial import (decode_picture_spatial,
                                        loop_filters_spatial,
                                        reconstruct_spatial)
    intra = [golds[n][0] for n in FOUR_STREAMS]
    smesh = Mesh(np.array(devs[:4]), ("stream",))
    t0 = time.perf_counter()
    outs = sharded_multistream_recon([build_tensor_plan(g.plan)
                                      for g in intra], smesh)
    for s, g in enumerate(intra):
        for c in range(3):
            assert_equal(f"stream mesh {FOUR_STREAMS[s]} plane {c}",
                         outs[s][c], g.prefilter[c])
    log("four", f"sharded_multistream_recon, 4-way stream mesh, "
                f"{', '.join(FOUR_STREAMS)}: bit-exact vs golden "
                f"({time.perf_counter() - t0:.3f} s incl. compile)")

    pmesh = Mesh(np.array(devs[:4]), ("space",))
    seq = golds["s1080_ldp4"]
    t0 = time.perf_counter()
    pre, filt = decode_picture_spatial(seq[1].plan, {seq[0].poc:
                                                     seq[0].planes}, pmesh)
    for c in range(3):
        assert_equal(f"space mesh P picture prefilter {c}", pre[c],
                     seq[1].prefilter[c])
        assert_equal(f"space mesh P picture plane {c}", filt[c],
                     seq[1].planes[c])
    log("four", f"decode_picture_spatial, 4-way space mesh, s1080_ldp4 "
                f"poc {seq[1].poc} (P): bit-exact vs golden "
                f"({time.perf_counter() - t0:.3f} s incl. compile)")
    g = intra[0]
    t0 = time.perf_counter()
    out = reconstruct_spatial(build_tensor_plan(g.plan), pmesh)
    filt = loop_filters_spatial(g.plan, out, pmesh)
    for c in range(3):
        assert_equal(f"space mesh intra prefilter {c}", out[c],
                     g.prefilter[c])
        assert_equal(f"space mesh intra plane {c}", filt[c], g.planes[c])
    log("four", f"reconstruct_spatial + loop_filters_spatial, 4-way space "
                f"mesh, s1080: bit-exact vs golden "
                f"({time.perf_counter() - t0:.3f} s incl. compile)")


# ---------------------------------------------------------------------------


def golden_decodes(names) -> dict:
    from p265_tpu.golden.decoder import GoldenDecoder
    from tools.make_streams import get_stream
    out = {}
    for name in names:
        t0 = time.perf_counter()
        out[name] = GoldenDecoder().decode_stream(get_stream(name))
        log("golden", f"{name}: {len(out[name])} frames in "
                      f"{time.perf_counter() - t0:.3f} s (host NumPy)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)
    devs = require_gpu(4 if args.four else 1)
    if args.four:
        devs = devs[:4]
    smi = phase_device(devs)
    if args.four:
        golds = golden_decodes(FOUR_STREAMS + ("s1080_ldp4",))
        phase_four(devs, golds)
    else:
        golds = golden_decodes(("s1080_ldp4", "s1080"))
        phase_kernels(golds["s1080_ldp4"][1])
        phase_decode(smi, golds, CompileCounter())
    log("card", smi)
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
