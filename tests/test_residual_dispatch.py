"""The Stage-B residual path (kernels/itransform.batch_residual, both
matmul formulations) vs golden/transform.py, lane kinds mixed: DST and
transform-skip lanes at 4x4, bypass lanes at every size, full-range levels."""
import numpy as np
import pytest

from p265_tpu.golden.transform import batch_residual_reference, random_tu_batch
from p265_tpu.kernels.itransform import batch_residual


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_residual_vs_golden(log2):
    rng = np.random.default_rng(100 + log2)
    lv, qp, dst, tskip, bypass = random_tu_batch(rng, log2, 96)
    if log2 == 2:
        assert dst.any() and tskip.any()
    assert bypass.any()
    want = batch_residual_reference(lv, qp, dst, tskip, bypass, log2)
    for use_mxu in (True, False):
        got = np.asarray(batch_residual(lv, qp, dst, tskip, log2, use_mxu,
                                        bypass=bypass))
        assert np.array_equal(got, want), use_mxu
