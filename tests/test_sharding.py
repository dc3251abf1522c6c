"""Sharded execution == unsharded, bit-exact (determinism gate, SURVEY.md 5)."""
import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.kernels.loopfilter import sao_tpu
from p265_tpu.plan.frame_plan import build_tensor_plan
from p265_tpu.shard.decoder import sharded_multistream_recon
from p265_tpu.shard.filters import sao_sharded
from p265_tpu.shard.mesh import make_mesh, sharded_stencil_step
from p265_tpu.testgen.encoder import IntraEncoder, make_test_image


def _mesh1d(n, name="stream"):
    return Mesh(np.array(jax.devices()[:n]).reshape(n), (name,))


def _make_streams(n, w=96, h=64):
    plans, golds = [], []
    for seed in range(n):
        sps = SPS(pic_width=w, pic_height=h)
        pps = PPS(init_qp=32, sign_data_hiding=True)
        img = make_test_image(w, h, seed + 20)
        stream, _, _ = IntraEncoder(sps, pps, qp=32, seed=seed + 20
                                    ).encode_frame(img)
        g = GoldenDecoder().decode_stream(stream)[0]
        golds.append(g)
        plans.append(build_tensor_plan(g.plan))
    return plans, golds


def test_multistream_dp_bit_exact():
    n = 4
    plans, golds = _make_streams(n)
    mesh = _mesh1d(n)
    outs = sharded_multistream_recon(plans, mesh)
    for s in range(n):
        for c in range(3):
            assert np.array_equal(outs[s][c], golds[s].prefilter[c]), (s, c)


def test_multistream_dp_lane_cap_above_8():
    """Steps holding more than 8 TUs of one size (512x512 intra: 16 lanes of
    4x4): the fleet-common lane cap must come from each step map."""
    from p265_tpu.pipeline.wavefront import _stack_plane
    from tools.make_streams import _intra
    golds = [GoldenDecoder().decode_stream(_intra(512, 512, seed=s))[0]
             for s in (3, 4)]
    plans = [build_tensor_plan(g.plan) for g in golds]
    assert max(d["idx_map"].shape[1] for tp in plans for pp in tp.planes
               if pp.batches for d in _stack_plane(pp)[1].values()) > 8
    outs = sharded_multistream_recon(plans, _mesh1d(2))
    for s, g in enumerate(golds):
        for c in range(3):
            assert np.array_equal(outs[s][c], g.prefilter[c]), (s, c)


def test_sao_halo_sharded_bit_exact():
    plans, golds = _make_streams(1, w=128, h=128)
    g = golds[0]
    mesh = _mesh1d(4, "space")
    sharded = sao_sharded(g.plan, g.prefilter, mesh)
    unsharded = sao_tpu(g.plan, [np.asarray(p) for p in g.prefilter])
    for c in range(3):
        assert np.array_equal(sharded[c], np.asarray(unsharded[c])), c


def test_stencil_step_runs():
    mesh = make_mesh(8)
    s_ax, r_ax = mesh.devices.shape
    planes = (np.arange(2 * s_ax * 16 * r_ax * 64, dtype=np.int32)
              .reshape(2 * s_ax, 16 * r_ax, 64) & 255)
    import jax.numpy as jnp
    out = sharded_stencil_step(mesh, jnp.asarray(planes))
    assert np.asarray(out).shape == planes.shape
