"""Operations and bytes counted by the benchmark against sums written out
by hand at small shapes."""

import torch
import torch.nn.functional as F

from perfbench import counting


def test_conv_flops_are_two_per_multiply_add():
    x = torch.zeros(2, 3, 8, 8)
    w1, w2 = torch.zeros(5, 3, 3, 3), torch.zeros(5, 4, 2, 2)

    def net():
        y = F.conv2d(x, w1, padding=1)  # 2 * 8 * 8 * 5 outputs, 27 MACs each
        F.conv_transpose2d(y, w2, stride=2)  # each input feeds 4 * 4 outputs

    flops = counting.count_flops(net)
    assert flops == 2 * (2 * 8 * 8 * 5 * 27) + 2 * (2 * 5 * 8 * 8 * 4 * 2 * 2)


def test_counted_flops_include_the_backward():
    x = torch.zeros(1, 2, 4, 4, requires_grad=True)
    w = torch.zeros(3, 2, 3, 3, requires_grad=True)
    fwd = 2 * 4 * 4 * 3 * 18
    flops = counting.count_flops(lambda: F.conv2d(x, w, padding=1).sum().backward())
    assert flops == 3 * fwd  # forward, grad of the input, grad of the weight


def test_hann_stitch_bytes_are_its_tensors():
    from satellite_computervision_tpu_torch.kernels.stitch import _axis_weight_sum, hann_window_1d

    rows, cols, k, side, c = 3, 2, 16, 24, 1
    chips = torch.zeros(rows * cols, side, side, c)
    canvas = torch.zeros((rows + 1) * k, (cols + 1) * k, c)
    vectors = [hann_window_1d(side), _axis_weight_sum(rows, k, side), _axis_weight_sum(cols, k, side)]
    want = chips.nbytes + canvas.nbytes + sum(v.nbytes for v in vectors)
    assert counting.hann_stitch_bytes(rows, cols, k, side, c) == want


def test_fused_preprocess_bytes_are_its_tensors():
    from satellite_computervision_tpu_torch.kernels.preprocess import draw_augment_params

    b, k, c, n_color = 4, 16, 7, 6
    stack = torch.zeros(b, k, k, c)
    draws = draw_augment_params(torch.Generator().manual_seed(0), b, n_color)
    want = 2 * stack.nbytes + sum(d.to(torch.float32).nbytes for d in draws)
    assert counting.fused_preprocess_bytes(b, k, c, n_color) == want
    assert counting.fused_preprocess_bytes(b, k, c, n_color, augment=False) == 2 * stack.nbytes


def test_peaks_are_published_h100_rates():
    row = counting.PEAKS["NVIDIA H100 80GB HBM3"]
    assert row["bf16_flop_s"] == 989e12 and row["hbm_byte_s"] == 3.35e12
    assert counting.peak("a card not in the table", "bf16_flop_s") is None
