"""Percent of its roofline that ``morph_recon_kernel`` reached: each
reconstruction of an (H, W) float32 marker under its mask needs both
read once and the result written once, 12 bytes a pixel, at the HBM
peak (its operations, a few a pixel, bound it far less)."""

from benchkit.peaks import roofline_share


def read(run):
    h, w = run.own.tile_shape
    return roofline_share(run, "morph_recon_kernel", 12.0 * h * w, 10.0 * h * w)
