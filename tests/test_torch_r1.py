"""The forward march's host-side rule on the CPU: the warps (rays) per block
that R1's wrapper takes (``ops/kernels/renderer_fw.py``).  No JAX; the
kernel itself runs in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

from lightplane_tpu_torch.ops.kernels import renderer_fw


def r1_smem(width, n_layers, color_chn=3):
    """renderer_fw.cu's shared memory per block by warps, in bytes: the
    padded [W, W] tiles of the layers that run on the tensor cores, the
    heads' last layers compact (weights and biases of the outputs used,
    rounded up to 16 bytes) and two [32, W + 4] tiles per warp."""
    def last(n_out):
        return -(-(width * n_out + n_out) // 4) * 4

    return {w: 4 * ((n_layers - 2) * (width * width + width) + last(1)
                    + last(color_chn) + w * 2 * 32 * (width + 4))
            for w in renderer_fw.WARPS_PER_BLOCK}


@pytest.mark.parametrize("width, n_layers, want", [
    (32, 6, 4),     # the render headline and the scene fitter: 54,304 bytes
    (32, 24, 4),    # the deepest MLPs the kernel takes, 8/8/8
    (64, 6, 4),     # the 1/3/2 and 0/1/3 parity configs
    (64, 11, 4),    # 219,792 bytes
    (64, 12, 2),    # four warps need 236,432
    (64, 13, 2),
    (64, 14, 1),
    (64, 15, None),  # not even one warp fits
])
def test_warps_per_block_rule(width, n_layers, want):
    assert renderer_fw.pick_warps_per_block(r1_smem(width, n_layers)) == want


def test_warps_per_block_limits():
    smem = r1_smem(32, 6)
    assert renderer_fw.pick_warps_per_block(smem, max_smem=50_000) == 2
    assert renderer_fw.pick_warps_per_block(smem, max_smem=35_000) == 1
    assert renderer_fw.pick_warps_per_block(smem, max_smem=25_000) is None
