"""Global constants (counterpart of ``lightplane_tpu/ops/const.py``)."""

# Minimum number of rendered channels; the color MLP's last layer is
# zero-padded up to this width, so one flat ``mlp_params`` vector has the
# same layout in both packages.
MIN_BLOCK_SIZE: int = 16
