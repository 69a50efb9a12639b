"""The whole step's share of the chip's float32-exact peak: the FLOP the
window's work needs (the backbone convs of every image extracted, counted
from the layer shapes at each image's size, plus the correlations' needed
FLOP) over the window's time at 495/3 TFLOP/s (``flops.PEAK_F32_FLOPS``)."""

from retrieval_bench.flops import PEAK_F32_FLOPS


def read(run):
    return 100.0 * (run.backbone_flop + run.ncc_flop) / (run.window_s * PEAK_F32_FLOPS)
