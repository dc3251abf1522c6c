"""Multi-process (multi-host) data-parallel decode (SURVEY.md 4.2.4,
config 5: multi-stream batch decode over N>=2 hosts).

Every process parses ONLY the streams it owns (streams are IRAP-delimited
and fully independent -- the codec-native DP axis), agrees on global program
shapes with one tiny allgather, builds its process-local shards of the
global stream-stacked input arrays, and joins one global shard_map whose
collectives ride the mesh.  Outputs come back per process as addressable
shards; each process verifies its own streams.

Tested single-host-multi-process (tests/test_distributed.py spawns 2
processes over a localhost coordinator with CPU devices); the same code
runs on several GPU hosts, per the jax.distributed contract.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from p265_tpu.pipeline.wavefront import _pow2, _run_plane, _stack_plane
from p265_tpu.shard.decoder import _pad_stream_plane


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices: int = 4, local_device_ids=None) -> None:
    """Join the distributed runtime (call before first device use).

    local_devices: CPU devices per process (tests).  local_device_ids: the
    GPUs this process opens; pass them when several processes share a host,
    or each would open (and reserve memory on) every card."""
    try:
        jax.config.update("jax_num_cpu_devices", local_devices)
    except Exception:
        pass
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_mesh(axis: str = "stream") -> Mesh:
    return Mesh(np.array(jax.devices()), (axis,))


def split_irap_segments(data: bytes) -> list[bytes]:
    """IRAP-delimited scheduling units (SURVEY.md 5 'failure recovery':
    IRAP pictures are sync-free entry points).  Splits an Annex-B stream
    at each IRAP picture whose slice has first_slice_segment_in_pic_flag
    set; every segment is prefixed with all parameter sets seen so far,
    making it independently decodable.  Segments preserve stream order."""
    from p265_tpu.hls import nal as nal_mod
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    sc = np.flatnonzero((arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] == 1))
    if len(sc) == 0:
        return [data]
    # a 4-byte start code owns its leading zero byte
    unit_starts = [int(s) - (1 if s > 0 and arr[s - 1] == 0 else 0)
                   for s in sc]
    unit_starts.append(n)
    params = b""
    segments: list[bytes] = []
    cur: list[bytes] = []
    cur_has_slice = False
    for i, s in enumerate(unit_starts[:-1]):
        raw = data[s:unit_starts[i + 1]]
        hdr_off = int(sc[i]) + 3 - s
        if len(raw) < hdr_off + 3:
            cur.append(raw)
            continue
        t = (raw[hdr_off] >> 1) & 63
        if t in (nal_mod.NAL_VPS, nal_mod.NAL_SPS, nal_mod.NAL_PPS):
            params += raw
            continue
        first_in_pic = bool(raw[hdr_off + 2] & 0x80)
        if nal_mod.is_irap(t) and first_in_pic and cur_has_slice:
            segments.append(b"".join(cur))
            cur, cur_has_slice = [], False
        if not cur:
            cur.append(params)
        cur.append(raw)
        if nal_mod.is_slice_nal(t):
            cur_has_slice = True
    if cur:
        segments.append(b"".join(cur))
    return segments


def schedule_segments(streams: list[bytes], num_processes: int,
                      process_id: int):
    """Round-robin IRAP segments of a stream batch over processes.

    Returns (my_work, layout): my_work = [(stream_idx, seg_idx, bytes)]
    owned by this process; layout = per-stream segment counts, so results
    can be reassembled in global order after an allgather."""
    all_segs = [(si, gi, seg)
                for si, s in enumerate(streams)
                for gi, seg in enumerate(split_irap_segments(s))]
    my_work = [w for i, w in enumerate(all_segs)
               if i % num_processes == process_id]
    layout = [len(split_irap_segments(s)) for s in streams]
    return my_work, layout


def decode_segments_production(my_segments: list[bytes],
                               use_native_parse: bool = True):
    """Decode IRAP segments through the PRODUCTION TpuDecoder (native C
    Stage-A parse, fused device MC from device-resident DPB slabs, loop
    filters, full DPB) under the jax.distributed runtime, with GLOBAL
    Stage-B shape agreement (the real decoder, not a frame[0]-intra demo).

    Protocol: (1) every process parses + tensorizes only its own segments,
    feeding one shared ShapePolicy; (2) one allgather merges every
    process's policy (elementwise max of ladder rungs) so all processes
    compile IDENTICAL programs -- compile skew across hosts is the classic
    multi-host failure mode; (3) each process dispatches its deferred
    recon queues on its local device.  Returns per-segment lists of
    DecodedFrames (output order within the segment)."""
    from jax.experimental import multihost_utils

    from p265_tpu.pipeline.decoder import TpuDecoder
    from p265_tpu.pipeline.wavefront import ShapePolicy

    policy = ShapePolicy()
    decs = []
    from p265_tpu.hls import nal as nal_mod
    for seg in my_segments:
        d = TpuDecoder(shape_policy=policy,
                       use_native_parse=use_native_parse,
                       calibrate_frames=1 << 30)   # defer until agreement
        d._recon_queue = []
        for unit in nal_mod.split_nal_units(seg):
            d.decode_nal(unit)
        decs.append(d)
    if jax.process_count() > 1:
        merged = multihost_utils.process_allgather(policy.state_vector())
        policy.merge_state(np.max(np.atleast_2d(merged), axis=0))
    return [d.flush() for d in decs]


def decode_streams_distributed(my_streams: list[bytes], mesh: Mesh,
                               axis: str = "stream", use_mxu: bool = True):
    """Decode this process's streams as its shard of a global DP batch.

    my_streams: one Annex-B stream per LOCAL device (the global batch is the
    concatenation over processes, in process order).  Returns per-local-
    stream [y, cb, cr] numpy planes, bit-exact vs unsharded decode.
    """
    from p265_tpu.golden.decoder import GoldenDecoder
    from p265_tpu.plan.frame_plan import build_tensor_plan
    from jax.experimental import multihost_utils

    n_local = len([d for d in mesh.devices.flat
                   if d.process_index == jax.process_index()])
    assert len(my_streams) == n_local, (len(my_streams), n_local)

    # Stage A: parse ONLY the local streams (host-parallel across processes)
    tplans = []
    for s in my_streams:
        g = GoldenDecoder().decode_stream(s)[0]
        tplans.append(build_tensor_plan(g.plan))

    # agree on global program shapes: allgather each process's needs, max
    from p265_tpu.plan.frame_plan import LOG2_SIZES
    need = np.zeros(1 + len(LOG2_SIZES), np.int64)
    for tp in tplans:
        for p_idx in range(3):
            pp = tp.planes[p_idx]
            if not pp.batches:
                continue
            ns, st = _stack_plane(pp)
            need[0] = max(need[0], ns)
            for i, log2 in enumerate(LOG2_SIZES):
                if log2 in st:
                    need[1 + i] = max(need[1 + i], st[log2]["idx_map"].shape[1])
    all_needs = multihost_utils.process_allgather(need)
    gmax = np.max(np.atleast_2d(all_needs), axis=0)
    n_steps = int(_pow2(max(int(gmax[0]), 8)))
    caps = {log2: int(_pow2(max(int(gmax[1 + i]), 8)))
            for i, log2 in enumerate(LOG2_SIZES)}

    # build process-local shards of the global [S, ...] arrays
    per_plane = []
    for p_idx in range(3):
        pps_ = [tp.planes[p_idx] for tp in tplans]
        shape = pps_[0].shape
        sizes = tuple(LOG2_SIZES)
        streams = [_pad_stream_plane(pp, sizes, n_steps, caps, use_mxu)
                   for pp in pps_]
        stacked = jax.tree.map(lambda *xs: np.stack(xs),
                               *[s for s, _, _ in streams])
        residuals = jax.tree.map(lambda *xs: np.stack(xs),
                                 *[r for _, r, _ in streams])
        preds = np.stack([p for _, _, p in streams])
        per_plane.append((stacked, residuals, preds, shape, sizes))

    sharding = NamedSharding(mesh, P(axis))

    def to_global(local_np):
        return jax.make_array_from_process_local_data(sharding, local_np)

    def body(*flat):
        it = iter(flat)
        outs = []
        for (_, _, _, shape, sizes) in per_plane:
            stacked = jax.tree.map(lambda a: a[0], next(it))
            residuals = jax.tree.map(lambda a: a[0], next(it))
            pred = next(it)[0]
            c_idx = min(len(outs), 1)
            out = _run_plane.__wrapped__(stacked, residuals, sizes, c_idx,
                                         shape, pred)
            outs.append(out[None])
        return tuple(outs)

    flat_in = []
    for (stacked, residuals, preds, _, _) in per_plane:
        flat_in += [jax.tree.map(to_global, stacked),
                    jax.tree.map(to_global, residuals),
                    to_global(preds)]
    leaf = P(axis)
    in_specs = tuple(jax.tree.map(lambda _: leaf, x,
                                  is_leaf=lambda l: hasattr(l, "shape"))
                     if not isinstance(x, jax.Array) else leaf
                     for x in flat_in)
    fn = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=(leaf,) * 3, check_vma=False)
    outs = jax.jit(fn)(*flat_in)

    results = [[] for _ in range(n_local)]
    for p in range(3):
        shards = sorted(
            (s for s in outs[p].addressable_shards),
            key=lambda s: s.index[0].start)
        assert len(shards) == n_local
        for li, sh in enumerate(shards):
            results[li].append(np.asarray(sh.data)[0])
    return results
