"""chip_smoke.py and its GPU checks (p265_tpu.device): the helpers on the
CPU, the kernel phase on a card."""
import json

import numpy as np
import pytest

import chip_smoke
from p265_tpu import device


def test_require_gpu_exits_nonzero_on_cpu():
    with pytest.raises(SystemExit) as e:
        device.require_gpu()
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)


def test_result_line_shape():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line([Dev()] * 4))["device"][
        "count"] == 4


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n", ("NVIDIA H100 80GB HBM3",
                                            "500.00 W")),
    ("Some, Card, 350 W", ("Some, Card", "350 W")),
])
def test_parse_smi(line, want):
    assert device.parse_smi(line) == want


@pytest.mark.parametrize("line", ["", "NVIDIA H100", ", 700 W",
                                  "NVIDIA H100,"])
def test_parse_smi_rejects_malformed(line):
    with pytest.raises(ValueError):
        device.parse_smi(line)


def test_assert_equal_reports_mismatch():
    a = np.zeros((2, 3), np.int32)
    chip_smoke.assert_equal("same", a, a.copy())
    b = a.copy()
    b[1, 2] = 1
    with pytest.raises(AssertionError, match=r"\[\[1, 2\]\]"):
        chip_smoke.assert_equal("diff", b, a)
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.assert_equal("shape", a[:1], a)


@pytest.mark.gpu
def test_kernels_on_card(gpu):
    """The kernel phase of chip_smoke.py at its 1080p bucket shapes."""
    rng = np.random.default_rng(2024)
    chip_smoke.check_residual(rng)
    chip_smoke.check_intra(rng)
    chip_smoke.check_mc(rng)
