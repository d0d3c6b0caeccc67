"""lightplane_tpu_torch: the PyTorch / CUDA port of ``lightplane_tpu``.

The renderer (3D -> 2D) and the splatter (2D -> 3D), forward and backward.
``lightplane_renderer`` and the ``LightplaneRenderer`` module run the fused
Emission-Absorption march and its O(1)-in-samples recompute backward;
``lightplane_splatter``, ``lightplane_mlp_splatter`` (and
``lightplane_splatter_raw``) and the ``LightplaneSplatter`` /
``LightplaneMLPSplatter`` modules run the fused splat and its gather
adjoint.  On NVIDIA Hopper GPUs each pass is a hand-written CUDA kernel
(``csrc/renderer_fw.cu``, ``csrc/renderer_bw.cu``, ``csrc/splatter_fw.cu``,
``csrc/splatter_bw.cu``, built with ``nvcc`` at first use); on the CPU it is
the kernel's plain PyTorch version.  Gradients reach the grid-lists, the
MLPs' flat ``mlp_params`` and the ray encodings, so a splat can be rendered
back and trained end to end.  The renderer gates its march by an occupancy
scaffold (``LightplaneRenderer.calculate_scaffold``) and takes a separate
relu-field colour grid.  ``utils.grid_utils`` holds the fitting
regularisers, ``utils.cameras`` pinhole rays, ``utils.metrics`` PSNR, SSIM,
LPIPS and the perceptual loss, ``utils.nnfm_loss`` the style losses and
their feature extractors, ``utils.io_utils`` PNG reading and writing and
video, ``utils.profiling`` device timers and memory, ``utils.visualize``
plotly pictures of rays, ``examples.datasets`` the NeRF-synthetic, LLFF,
NSVF and CO3D loaders, and ``examples.fit_single_scene`` the
scene-fitting trainer.  Factories build on the GPU
unless asked for ``device="cpu"``.  Names, layouts (channels-last
grid-lists, the flat ``mlp_params`` vectors) and numerics follow the JAX
package, which stays the reference.  This package never imports JAX.
"""

from .ops.const import MIN_BLOCK_SIZE
from .ops.rays import (
    Rays,
    calc_harmonic_embedding,
    calc_harmonic_embedding_dim,
    default_tile,
    jitter_near_far,
    tile_ray_order,
)
from .ops.misc_utils import (
    flatten_grid,
    unflatten_grid,
    if_not_none_else,
    pad_feature_to_block_size,
    is_in_bounds,
    check_grid,
    check_grid_and_color_grid,
    process_and_flatten_grid,
)
from .ops.mlp_utils import (
    DecoderParams,
    SplatterParams,
    init_decoder_params,
    init_splatter_params,
    flatten_decoder_params,
    flatten_splatter_params,
    flattened_decoder_params_to_list,
    flattened_triton_decoder_to_list,
    get_triton_function_input_dims,
)
from .ops.rand import int_to_randn, int_to_randn_naive
from .ops.naive_renderer import (
    lightplane_renderer_naive,
    lightplane_eval_mlp,
    lightplane_eval_mlp_opacity_only,
)
from .ops.renderer import lightplane_renderer, suggest_w3_budget
from .ops.naive_splatter import (
    lightplane_splatter_naive,
    lightplane_mlp_splatter_naive,
)
from .ops.splatter import (
    lightplane_splatter,
    lightplane_mlp_splatter,
    lightplane_splatter_raw,
)
from .models.renderer_module import LightplaneRenderer
from .models.splatter_module import LightplaneSplatter, LightplaneMLPSplatter
from .utils.visualize import visualize_rays_plotly

__version__ = "0.1.0"
