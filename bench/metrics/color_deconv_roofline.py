"""Percent of its roofline that ``color_deconv_kernel`` reached: three
uint8 channels of an (H, W) tile read once and three float32 stain
planes written once, 15 bytes a pixel, against 30 float32 operations a
pixel (the bytes bound it)."""

from benchkit.peaks import roofline_share


def read(run):
    h, w = run.own.tile_shape
    return roofline_share(run, "color_deconv_kernel", 15.0 * h * w, 30.0 * h * w)
