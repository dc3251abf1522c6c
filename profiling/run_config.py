"""Decode one benchmark stream on the device: cold + warm + split rows.

Usage: python profiling/run_config.py <stream-name> [n_warm]

Covers BASELINE.json configs 3/4/5 geometry (VERDICT r4 ask #3):
  s1080_ra8  -- 1080p random-access B-GOP (first bi-pred program at 1080p)
  s1080_t8   -- 1080p 4x2 tiles, intra
  s4k        -- 3840x2160 intra
Gates every decoded frame bit-exact vs the golden scalar decoder, then
prints cold/warm wall-clock and the parse/pack/upload/dispatch/fetch split.
"""
import functools
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "s1080_ra8"
    n_warm = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    from tools.make_streams import get_stream
    from p265_tpu.golden.decoder import GoldenDecoder
    from p265_tpu.pipeline.async_decoder import PipelinedTpuDecoder

    data = get_stream(name)
    log(f"{name}: {len(data)} bytes")
    kw = {}
    if os.environ.get("P265_TPU_FRAME_DAG_MAX"):
        kw["frame_dag_max"] = int(os.environ["P265_TPU_FRAME_DAG_MAX"])
    if os.environ.get("P265_TPU_CALIBRATE"):
        kw["calibrate_frames"] = int(os.environ["P265_TPU_CALIBRATE"])
    PipelinedTpuDecoder = functools.partial(PipelinedTpuDecoder, **kw)

    dec = PipelinedTpuDecoder()
    t0 = time.perf_counter()
    gold = GoldenDecoder().decode_stream(data)
    golden_s = time.perf_counter() - t0
    log(f"golden: {golden_s:.1f} s for {len(gold)} frames "
        f"({len(gold) / golden_s:.3f} fps)")

    t0 = time.perf_counter()
    frames = dec.decode_stream(data)
    cold_s = time.perf_counter() - t0
    log(f"cold decode: {cold_s:.1f} s; stats:",
        {k: round(v, 3) for k, v in dec.stats.items()
         if isinstance(v, float)})

    assert len(frames) == len(gold), (len(frames), len(gold))
    for f, g in zip(frames, gold):
        for c in range(3):
            assert np.array_equal(np.asarray(f.planes[c]), g.planes[c]), \
                ("bit-exact gate", f.poc, c)
    log("bit-exact gate vs golden: OK")
    n = len(frames)
    del frames, dec, gold

    times = []
    for _ in range(n_warm):
        gc.collect()
        d = PipelinedTpuDecoder()
        t0 = time.perf_counter()
        out = d.decode_stream(data)
        dt = time.perf_counter() - t0
        times.append(dt)
        log(f"warm decode: {dt:.2f} s ({n / dt:.3f} fps); stats:",
            {k: round(v, 3) for k, v in d.stats.items()
             if isinstance(v, float)})
        del out, d
    log(f"{name}: golden {golden_s:.1f} s; cold {cold_s:.1f} s; "
        f"warm best {min(times):.2f} s = {n / min(times):.3f} fps "
        f"({golden_s / min(times):.1f}x golden)")


if __name__ == "__main__":
    main()
