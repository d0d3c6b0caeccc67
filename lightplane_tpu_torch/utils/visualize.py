"""Interactive plotly pictures of ray batches (counterpart of
``lightplane_tpu/utils/visualize.py``): one 3D subplot per ``grid_idx`` with
the [-1, 1] cube, ray segments from near to far, near and far endpoint
markers (pixel colours at the near points) and axis bounds fitted to the
ray endpoints.  :func:`rays_plot_data` computes the geometry in numpy;
:func:`visualize_rays_plotly` imports plotly only when it is called.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.rays import Rays


def _cube_edges():
    """Vertex pairs of the [-1, 1]^3 cube wireframe."""
    corners = np.array(
        [
            [x, y, z]
            for x in (-1.0, 1.0)
            for y in (-1.0, 1.0)
            for z in (-1.0, 1.0)
        ]
    )
    edges = []
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(np.abs(corners[i] - corners[j])) == 2.0:
                edges.append((corners[i], corners[j]))
    return edges


def _segments_trace(go, starts, ends, name, color=None, width=2.0):
    """A single plotly trace drawing many disconnected segments."""
    n = starts.shape[0]
    xs = np.full((n, 3), np.nan)
    ys = np.full((n, 3), np.nan)
    zs = np.full((n, 3), np.nan)
    xs[:, 0], xs[:, 1] = starts[:, 0], ends[:, 0]
    ys[:, 0], ys[:, 1] = starts[:, 1], ends[:, 1]
    zs[:, 0], zs[:, 1] = starts[:, 2], ends[:, 2]
    return go.Scatter3d(
        x=xs.ravel(),
        y=ys.ravel(),
        z=zs.ravel(),
        mode="lines",
        name=name,
        line=dict(width=width, color=color),
    )


def rays_plot_data(
    rays: Rays,
    pixel_colors: Optional[np.ndarray] = None,
    max_display_rays: int = 512,
):
    """Pure-data plot spec for a ray batch, one entry per grid index.

    Returns a list of dicts with keys ``grid_idx``, ``p_near``/``p_far``
    (``[n, 3]``), ``near_colors`` (a list of plotly rgb strings, or None;
    pixel colours are drawn at the near points), and ``axis_range``
    (``[3, 2]``): per-scene bounds of centre +- the largest spread of the
    ray endpoints, merged with the [-1, 1] cube.
    """
    def arr(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    dirs = arr(rays.directions)
    origins = arr(rays.origins)
    near = arr(rays.near)
    far = arr(rays.far)
    grid_idx = arr(rays.grid_idx)
    uniq = np.unique(grid_idx)

    scenes = []
    for g in uniq:
        sel = np.where(grid_idx == g)[0]
        if len(sel) > max_display_rays:
            sel = sel[
                np.linspace(0, len(sel) - 1, max_display_rays).astype(int)
            ]
        o = origins[sel]
        d = dirs[sel]
        p_near = o + near[sel][:, None] * d
        p_far = o + far[sel][:, None] * d

        near_colors = None
        if pixel_colors is not None:
            cols255 = (
                np.clip(arr(pixel_colors)[sel], 0.0, 1.0) * 255
            ).astype(int)
            near_colors = [f"rgb({r},{gg},{b})" for r, gg, b in cols255]

        ends = np.concatenate([p_near, p_far], axis=0)
        center = ends.mean(axis=0)
        max_expand = float((ends.max(axis=0) - ends.min(axis=0)).max())
        lo = np.minimum(center - max_expand, -1.0)
        hi = np.maximum(center + max_expand, 1.0)
        scenes.append(dict(
            grid_idx=int(g),
            p_near=p_near,
            p_far=p_far,
            near_colors=near_colors,
            axis_range=np.stack([lo, hi], axis=1),
        ))
    return scenes


def visualize_rays_plotly(
    rays: Rays,
    pixel_colors: Optional[np.ndarray] = None,
    max_display_rays: int = 512,
    ray_line_width: float = 1.5,
    marker_size: float = 2.0,
    title: str = "rays",
):
    """A plotly figure of a ray batch, one subplot per grid index.

    Args:
        rays: the ray batch to display.
        pixel_colors: optional ``[B, 3]`` RGB in [0, 1] drawn at the rays'
            near points.
        max_display_rays: the most rays drawn per scene.

    Returns:
        a ``plotly.graph_objects.Figure``.
    """
    import plotly.graph_objects as go
    from plotly.subplots import make_subplots

    scenes = rays_plot_data(rays, pixel_colors, max_display_rays)

    fig = make_subplots(
        rows=1,
        cols=len(scenes),
        specs=[[{"type": "scene"}] * len(scenes)],
        subplot_titles=[f"grid_idx={s['grid_idx']}" for s in scenes],
    )

    for col, sc in enumerate(scenes, start=1):
        g = sc["grid_idx"]
        p_near, p_far = sc["p_near"], sc["p_far"]
        for e0, e1 in _cube_edges():
            fig.add_trace(
                go.Scatter3d(
                    x=[e0[0], e1[0]],
                    y=[e0[1], e1[1]],
                    z=[e0[2], e1[2]],
                    mode="lines",
                    showlegend=False,
                    line=dict(color="gray", width=1),
                ),
                row=1,
                col=col,
            )
        fig.add_trace(
            _segments_trace(
                go, p_near, p_far, f"rays_{g}", width=ray_line_width
            ),
            row=1,
            col=col,
        )
        # near and far endpoint markers; pixel colours at the near points
        near_kwargs = dict(size=marker_size)
        if sc["near_colors"] is not None:
            near_kwargs["color"] = sc["near_colors"]
        for pts, name, mk in (
            (p_near, f"near_{g}", near_kwargs),
            (p_far, f"far_{g}", dict(size=marker_size)),
        ):
            fig.add_trace(
                go.Scatter3d(
                    x=pts[:, 0],
                    y=pts[:, 1],
                    z=pts[:, 2],
                    mode="markers",
                    name=name,
                    marker=mk,
                ),
                row=1,
                col=col,
            )
        lo, hi = sc["axis_range"][:, 0], sc["axis_range"][:, 1]
        scene = fig.layout[f"scene{col if col > 1 else ''}"]
        scene.update(
            xaxis=dict(range=[float(lo[0]), float(hi[0])]),
            yaxis=dict(range=[float(lo[1]), float(hi[1])]),
            zaxis=dict(range=[float(lo[2]), float(hi[2])]),
        )
    fig.update_layout(title=title)
    return fig
