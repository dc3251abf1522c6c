"""Multiple independent slices per picture (spec 7.3.6.1 / 6.4.1 slice
availability), bit-exact on golden and device paths."""
import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls import nal as N
from p265_tpu.hls.bitio import BitWriter
from p265_tpu.hls.params import PPS, SPS, write_pps, write_sps, write_vps
from p265_tpu.hls.slice_header import SLICE_I
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence, make_test_image


def _param_nals(sps, pps):
    out = b""
    for t, wfn, arg in ((N.NAL_VPS, write_vps, None),
                        (N.NAL_SPS, write_sps, sps),
                        (N.NAL_PPS, write_pps, pps)):
        w = BitWriter()
        (wfn(w) if arg is None else wfn(w, arg))
        out += N.make_nal(t, w.get_bytes())
    return out


def test_multislice_intra():
    sps = SPS(pic_width=256, pic_height=128)
    pps = PPS(init_qp=31, sign_data_hiding=True)
    enc = Encoder(sps, pps, qp=31, seed=30)
    img = make_test_image(256, 128, 30)
    nb, plan, prefilter, filtered = enc.encode_frame(
        img, poc=0, slice_type=SLICE_I, num_slices=3)
    stream = _param_nals(sps, pps) + nb
    assert sum(1 for u in N.split_nal_units(stream)
               if N.is_slice_nal(u.nal_type)) == 3
    g = GoldenDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(g.planes[c], filtered[c])
    t = TpuDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(t.planes[c], g.planes[c])


def test_multislice_p_gop():
    sps = SPS(pic_width=192, pic_height=96, temporal_mvp_enabled=True)
    pps = PPS(init_qp=33, sign_data_hiding=True)
    frames = make_moving_sequence(192, 96, 3, seed=31)
    stream, recons = Encoder(sps, pps, qp=33, seed=31).encode_sequence(
        frames, num_slices=2)
    gold = GoldenDecoder().decode_stream(stream)
    for f in gold:
        assert len(set(f.plan.slice_of_ctb.tolist())) == 2
        for c in range(3):
            assert np.array_equal(f.planes[c], recons[f.poc][c])


def test_dependent_slice_segments():
    from p265_tpu.pipeline.decoder import TpuDecoder
    sps = SPS(pic_width=256, pic_height=128)
    pps = PPS(init_qp=31, sign_data_hiding=True,
              dependent_slice_segments_enabled=True)
    enc = Encoder(sps, pps, qp=31, seed=33)
    img = make_test_image(256, 128, 33)
    nb, plan, prefilter, filtered = enc.encode_frame(
        img, poc=0, slice_type=SLICE_I, num_slices=3, dependent_slices=True)
    stream = _param_nals(sps, pps) + nb
    units = [u for u in N.split_nal_units(stream) if N.is_slice_nal(u.nal_type)]
    assert len(units) == 3
    g = GoldenDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(g.planes[c], filtered[c])
    t = TpuDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(t.planes[c], g.planes[c])


def test_multislice_tiles_intra():
    # slices aligned to whole tiles (spec conformance shape): 2x2 tiles,
    # 2 slices of 2 tiles each, 1 entry point per slice
    sps = SPS(pic_width=256, pic_height=128)
    pps = PPS(init_qp=31, sign_data_hiding=True, tiles_enabled=True,
              num_tile_columns=2, num_tile_rows=2)
    enc = Encoder(sps, pps, qp=31, seed=40)
    img = make_test_image(256, 128, 40)
    nb, plan, prefilter, filtered = enc.encode_frame(
        img, poc=0, slice_type=SLICE_I, num_slices=2)
    stream = _param_nals(sps, pps) + nb
    units = [u for u in N.split_nal_units(stream)
             if N.is_slice_nal(u.nal_type)]
    assert len(units) == 2
    g = GoldenDecoder().decode_stream(stream)[0]
    assert len(set(g.plan.slice_of_ctb.tolist())) == 2
    for c in range(3):
        assert np.array_equal(g.planes[c], filtered[c])
    t = TpuDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(t.planes[c], g.planes[c])


def test_multislice_wpp_intra():
    # 4x2 CTBs with WPP: 2 rows -> 2 slices of one row each (each slice's
    # first row re-inits: the sync source is in a different slice) and the
    # 2-rows-in-slice-1 case where sync stays intra-slice
    for n_slices in (2,):
        sps = SPS(pic_width=256, pic_height=128)
        pps = PPS(init_qp=31, sign_data_hiding=True,
                  entropy_coding_sync_enabled=True)
        enc = Encoder(sps, pps, qp=31, seed=41)
        img = make_test_image(256, 128, 41)
        nb, plan, prefilter, filtered = enc.encode_frame(
            img, poc=0, slice_type=SLICE_I, num_slices=n_slices)
        stream = _param_nals(sps, pps) + nb
        g = GoldenDecoder().decode_stream(stream)[0]
        for c in range(3):
            assert np.array_equal(g.planes[c], filtered[c])
        t = TpuDecoder().decode_stream(stream)[0]
        for c in range(3):
            assert np.array_equal(t.planes[c], g.planes[c])


def test_multislice_wpp_three_rows():
    # 3 CTB rows, 2 slices: slice 0 = rows 0-1 (WPP sync inside the slice),
    # slice 1 = row 2 (sync source in another slice -> fresh init)
    sps = SPS(pic_width=256, pic_height=192)
    pps = PPS(init_qp=32, sign_data_hiding=True,
              entropy_coding_sync_enabled=True)
    enc = Encoder(sps, pps, qp=32, seed=42)
    img = make_test_image(256, 192, 42)
    nb, plan, prefilter, filtered = enc.encode_frame(
        img, poc=0, slice_type=SLICE_I, num_slices=2)
    stream = _param_nals(sps, pps) + nb
    g = GoldenDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(g.planes[c], filtered[c])


def test_dependent_slices_wpp():
    # dependent segments with WPP: the row-above context snapshot must carry
    # across the segment boundary (same slice -> sync source available)
    sps = SPS(pic_width=256, pic_height=192)
    pps = PPS(init_qp=31, sign_data_hiding=True,
              entropy_coding_sync_enabled=True,
              dependent_slice_segments_enabled=True)
    enc = Encoder(sps, pps, qp=31, seed=43)
    img = make_test_image(256, 192, 43)
    nb, plan, prefilter, filtered = enc.encode_frame(
        img, poc=0, slice_type=SLICE_I, num_slices=3, dependent_slices=True)
    stream = _param_nals(sps, pps) + nb
    g = GoldenDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(g.planes[c], filtered[c])
    t = TpuDecoder().decode_stream(stream)[0]
    for c in range(3):
        assert np.array_equal(t.planes[c], g.planes[c])


def test_multislice_tiles_p_gop():
    sps = SPS(pic_width=192, pic_height=128, temporal_mvp_enabled=True)
    pps = PPS(init_qp=33, sign_data_hiding=True, tiles_enabled=True,
              num_tile_columns=2, num_tile_rows=2)
    frames = make_moving_sequence(192, 128, 3, seed=44)
    stream, recons = Encoder(sps, pps, qp=33, seed=44).encode_sequence(
        frames, num_slices=2)
    gold = GoldenDecoder().decode_stream(stream)
    for f in gold:
        assert len(set(f.plan.slice_of_ctb.tolist())) == 2
        for c in range(3):
            assert np.array_equal(f.planes[c], recons[f.poc][c])
