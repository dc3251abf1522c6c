"""One cold s1080_ldp4 decode, with or without the ahead-of-time warm compile.

    JAX_COMPILATION_CACHE_DIR=<fresh dir> python profiling/probe_cold_start.py on|off
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.make_streams import get_stream
from p265_tpu.pipeline.async_decoder import PipelinedTpuDecoder

if sys.argv[1] == "off":
    PipelinedTpuDecoder._warm_compile = lambda self, task, policy: None
data = get_stream("s1080_ldp4")
t0 = time.perf_counter()
d = PipelinedTpuDecoder()
frames = d.decode_stream(data)
dt = time.perf_counter() - t0
print(f"[cold] warm compile {sys.argv[1]}: {len(frames)} frames, cold "
      f"{dt:.3f} s; stats "
      f"{ {k: round(v, 4) for k, v in d.stats.items() if isinstance(v, float)} }",
      flush=True)
