"""Visualization, off the tracking path (counterpart of
``orb_slam3_rgbl_tpu.viz``): views drawn into numpy images by ``raster`` and
written with ``io/png.write_png`` — the card's machine has no matplotlib."""
