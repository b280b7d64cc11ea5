"""``sdpa_roofline`` over a hand-written table: the attention kernels'
least time, from the ``vit.encoder`` spans' shapes, over their device
time, and no reading where the kernels and the spans' layers disagree."""

import pytest

from conftest import REPO
from perfbench import attention_counts, manifest, program_spans, tracing

READER = manifest.load_module(REPO / "perfbench" / "layer_metrics" / "sdpa_roofline.py",
                              "reader_sdpa_roofline")
H100 = "NVIDIA H100 80GB HBM3"
CUDNN = "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_kernel0_0"
ATTRS = {"chips": 32, "tokens": 785, "heads": 16, "head_dim": 64, "layers": 2,
         "dtype": "bfloat16"}


def _table(kernels=2, us=200.0):
    ev = [["host", tracing.WINDOW, 0.0, 1000.0, 1],
          ["kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", 10.0, 50.0, 0]]
    ev += [["kernel", CUDNN, 100.0 + 300.0 * i, us, 0] for i in range(kernels)]
    return {"window_us": 1000.0, "events": ev}


@pytest.fixture
def spans(monkeypatch):
    logged = [("serve.forward", 5.0, 900.0, {}), ("vit.encoder", 20.0, 800.0, dict(ATTRS)),
              ("vit.encoder", 1200.0, 1300.0, dict(ATTRS))]  # the second starts after the window
    monkeypatch.setattr(program_spans, "spans", lambda table: logged)


def test_counts_from_the_shapes():
    flops = attention_counts.sdpa_flops(32, 785, 16, 64)
    assert flops == 4 * 32 * 16 * 785 ** 2 * 64
    assert attention_counts.sdpa_bytes(32, 785, 16, 64, "bfloat16") == 4 * 32 * 16 * 785 * 64 * 2
    # 392 FLOPs a byte, above the card's 295: bound by compute
    assert attention_counts.sdpa_least_s(ATTRS, 989e12, 3.35e12) == pytest.approx(flops / 989e12)


def test_reads_least_over_device_time(spans):
    least = attention_counts.sdpa_least_s(ATTRS, 989e12, 3.35e12)
    value = READER.read(_table(), {"device_name": H100})
    assert value == pytest.approx(100.0 * 2 * least / 400e-6)
    assert READER.attention_kernels(_table()) == (2, pytest.approx(400e-6))


@pytest.mark.parametrize("kernels", [1, 3])
def test_no_reading_when_kernels_and_layers_disagree(spans, kernels):
    assert READER.read(_table(kernels), {"device_name": H100}) is None


def test_no_reading_without_a_peak_or_spans(spans, monkeypatch):
    assert READER.read(_table(), {"device_name": "cpu"}) is None
    monkeypatch.setattr(program_spans, "spans", lambda table: None)
    assert READER.read(_table(), {"device_name": H100}) is None
