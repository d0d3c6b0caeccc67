"""The kernels of one tree, alone, for an A/B of two trees on one card:
R1 and R2 at the render headline with its 2/2/2 decoder at hidden 32,
128 and 256 (chip_smoke.py phases 5 and 12's inputs), S1 and S2 at the
splat headline (phase 7's); medians of CUDA-event runs, one JSON line.

    python3 chip_ab.py TREE   # TREE: a checkout whose kernels it builds

Run it on both trees in turns (parent, change, change, parent), each from
its own checkout, in one call on the card."""
import json
import sys

import torch

if len(sys.argv) != 2 or not torch.cuda.is_available():
    raise SystemExit("usage: chip_ab.py TREE, on a machine with a CUDA card")
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu_torch.ops import splatter as smod  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw  # noqa: E402
from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw  # noqa: E402
from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw  # noqa: E402

assert rfw.__file__.startswith(sys.argv[1]), rfw.__file__
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
with torch.no_grad():
    for hidden, reps in ((32, (7, 7)), (128, (5, 3)), (256, (3, 2))):
        _, _, _, (cfg, geom, diff), g_out = cs.wide_headline_inputs(lp, hidden)
        out[f"R1_{hidden}"] = cs.cuda_ms(
            lambda: rfw.render_fwd_cuda(cfg, geom, diff), warmup=1,
            reps=reps[0])
        nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
        out[f"R2_{hidden}"] = cs.cuda_ms(
            lambda: rbw.render_bwd_cuda(cfg, geom, diff, nlt, g_out),
            warmup=1, reps=reps[1])
        del cfg, geom, diff, g_out, nlt
    n = cs.SPLAT_VIEWS * cs.SPLAT_VIEW_RES ** 2
    gen = torch.Generator().manual_seed(3)
    enc = (torch.randn((n, cs.SPLAT_VOXEL[-1]), generator=gen) * 0.1).cuda()
    rays = cs.view_rays(lp, cs.SPLAT_VIEWS, cs.SPLAT_VIEW_RES, enc)
    cfg, geom, _ = cs.splat_march(smod, rays, [cs.SPLAT_VOXEL],
                                  dict(num_samples=cs.SPLAT_SAMPLES), None,
                                  None, None)
    diff = (enc, None, None)
    out["S1"] = cs.cuda_ms(lambda: sfw.splat_fwd_cuda(cfg, geom, diff),
                           reps=7)
    g = torch.randn((cfg.v_total, cfg.out_chn), device="cuda")
    out["S2"] = cs.cuda_ms(lambda: sbw.splat_bwd_cuda(cfg, geom, diff, g),
                           reps=7)
print(json.dumps(out))
