"""Percent of its roofline that ``feature_fused_kernel`` reached: three
uint8 channels read once, the hematoxylin, eosin and gradient planes
written once in float32 and six moment sums, 15 bytes a pixel and 24,
against 60 float32 operations a pixel (the larger of the two times
bounds it: the bytes)."""

from benchkit.peaks import roofline_share


def read(run):
    h, w = run.own.tile_shape
    return roofline_share(run, "feature_fused_kernel", 15.0 * h * w + 24.0, 60.0 * h * w)
