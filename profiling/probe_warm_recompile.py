"""What the ahead-of-time warm compile costs a warm s1080_ldp4 decode.

    python profiling/probe_warm_recompile.py

One process: a first decode (compiles, or loads from the persistent cache),
then the first inter task's warm compile re-run three times on this thread
with JAX's compile events listed, then warm decodes with the warm compile
as shipped ("on") and with it skipped ("skip"), interleaved on, skip, skip,
on, five decodes each.  Every decode is gated bit-exact on the first one.
"""
import gc
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from tools.make_streams import get_stream  # noqa: E402
from p265_tpu.pipeline.async_decoder import PipelinedTpuDecoder  # noqa: E402


def stats(d):
    return {k: round(v, 4) for k, v in d.stats.items() if isinstance(v, float)}


data = get_stream("s1080_ldp4")
shipped = PipelinedTpuDecoder._warm_compile
captured = []


def capture(self, task, policy):
    captured.append((task, policy))
    shipped(self, task, policy)


PipelinedTpuDecoder._warm_compile = capture
t0 = time.perf_counter()
dec = PipelinedTpuDecoder()
ref = [[np.asarray(p) for p in f.planes] for f in dec.decode_stream(data)]
print(f"[first] {time.perf_counter() - t0:.4f} s; stats {stats(dec)}",
      flush=True)
PipelinedTpuDecoder._warm_compile = shipped

events = defaultdict(float)
jax.monitoring.register_event_duration_secs_listener(
    lambda ev, d, **k: events.__setitem__(ev, events[ev] + d))
task, policy = captured[0]
for i in range(3):
    events.clear()
    t0 = time.perf_counter()
    dec._warm_compile(task, policy)
    dt = time.perf_counter() - t0
    print(f"[rerun {i}] _warm_compile {dt:.4f} s; jax events "
          f"{ {k: round(v, 4) for k, v in events.items()} }", flush=True)

times = defaultdict(list)
for mode in ("on", "skip", "skip", "on"):
    PipelinedTpuDecoder._warm_compile = (
        shipped if mode == "on" else lambda self, task, policy: None)
    for _ in range(5):
        gc.collect()
        d = PipelinedTpuDecoder()
        t0 = time.perf_counter()
        frames = d.decode_stream(data)
        dt = time.perf_counter() - t0
        for f, r in zip(frames, ref):
            for c in range(3):
                assert np.array_equal(np.asarray(f.planes[c]), r[c])
        times[mode].append(dt)
        print(f"[warm {mode}] {dt:.4f} s; stats {stats(d)}", flush=True)
        del frames, d
for mode, ts in times.items():
    print(f"[summary] {mode}: best {min(ts):.4f} s, median "
          f"{sorted(ts)[len(ts) // 2]:.4f} s over {len(ts)}", flush=True)
