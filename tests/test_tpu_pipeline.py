"""Device pipeline (Stage B) vs golden decoder: bit-exact end to end."""
import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.testgen.encoder import IntraEncoder, make_test_image


def _compare(w, h, qp, seed, use_mxu=True):
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    img = make_test_image(w, h, seed)
    stream, _, _ = IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(img)
    gold = GoldenDecoder().decode_stream(stream)[0]
    tpu = TpuDecoder(use_mxu=use_mxu).decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(tpu.prefilter[c], gold.prefilter[c]), f"prefilter {c}"
        assert np.array_equal(tpu.planes[c], gold.planes[c]), f"filtered {c}"


def test_tpu_matches_golden_128():
    _compare(128, 128, 30, 11)


def test_tpu_matches_golden_nonaligned():
    _compare(104, 56, 26, 21)


def test_tpu_matches_golden_highqp():
    _compare(64, 64, 45, 31)


def test_tpu_int32_path():
    _compare(64, 64, 30, 5, use_mxu=False)


def test_frame_batched_scan_with_chroma_fold():
    # reconstruct_tpu_scan_frames folds F frames and cb+cr into merged
    # scans; must stay bit-exact vs per-frame golden recon
    from p265_tpu.pipeline.wavefront import reconstruct_tpu_scan_frames
    from p265_tpu.plan.frame_plan import build_tensor_plan
    golds, tplans = [], []
    for seed in (1, 2, 3):
        sps = SPS(pic_width=96, pic_height=64)
        pps = PPS(init_qp=30, sign_data_hiding=True)
        img = make_test_image(96, 64, seed)
        stream, _, _ = IntraEncoder(sps, pps, qp=30, seed=seed).encode_frame(img)
        g = GoldenDecoder().decode_stream(stream)[0]
        golds.append(g)
        tplans.append(build_tensor_plan(g.plan))
    outs = reconstruct_tpu_scan_frames(tplans)
    for g, o in zip(golds, outs):
        for c in range(3):
            assert np.array_equal(o[c], g.prefilter[c]), c
