"""Model FLOPs: the matrix products a step or a render chunk needs at
its live samples, counted from the configuration's MLP widths.

Only the MLPs' matrix products count (2 FLOPs a multiply-add); the hash
encode, the march and the shading arithmetic do not, and nothing is
counted twice for recomputation.  A backward costs twice its forward.
The widths come from ``mlp_dims``, read off the reference model, whose
MLPs are built from the configuration alone.

NeuS (analytic normals), per live sample of a train step: the geometry
MLP's forward and the normal's input gradient (one product of each
layer's size), both differentiated: ``6 g``; the radiance MLP ``3 t``.

The flagship (hybrid finite-difference normals), per live sample of a
train step: the geometry MLP at the sample and at its ``P`` probes,
``3 (1 + P) g``; the curvature probe on one sample in ``stride``, with
its input gradient, ``6 g / stride``; the four material and radiance
heads, ``3 (a + r + m + e)``; per ray, the secondary feature (one
geometry row) and the secondary head, ``3 (g + s)``.  The secondary
transmittance and the visibility probe read the baked SDF or take no
gradient through an MLP of their own and are not counted.

The flagship's render chunk (no backward; analytic normals): per live
sample ``2 g``, per visible sample the four heads, per ray ``g + s``.
"""

from __future__ import annotations

from typing import Dict, Sequence


def mlp_flops(dims: Sequence[int]) -> int:
    """Forward FLOPs of one row through an MLP of layer ``dims``."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_dims(model) -> Dict[str, list]:
    """``{name: dims}`` of the MLPs a configuration's model holds (the
    reference model's ``geometry.mlp`` and ``texture.*`` heads)."""
    out = {"geometry": list(model.geometry.mlp.dims)}
    tex = model.texture
    for name in ("mlp", "albedo", "roughness", "metallic", "env",
                 "secondary"):
        m = getattr(tex, name, None)
        if m is not None and hasattr(m, "dims"):
            out[name] = list(m.dims)
    return out


def neus_train_step(dims: Dict[str, list], live: float) -> float:
    g, t = mlp_flops(dims["geometry"]), mlp_flops(dims["mlp"])
    return live * (6 * g + 3 * t)


def _heads(dims):
    return sum(mlp_flops(dims[k]) for k in ("albedo", "roughness",
                                            "metallic", "env"))


def split_train_step(dims: Dict[str, list], live: float, rays: float,
                     probes: int, stride: int) -> float:
    g, s = mlp_flops(dims["geometry"]), mlp_flops(dims["secondary"])
    per_sample = 3 * (1 + probes) * g + 6 * g / stride + 3 * _heads(dims)
    return live * per_sample + rays * 3 * (g + s)


def split_render_chunk(dims: Dict[str, list], live: float, visible: float,
                       rays: float) -> float:
    g, s = mlp_flops(dims["geometry"]), mlp_flops(dims["secondary"])
    return live * 2 * g + visible * _heads(dims) + rays * (g + s)


def train_step(dims: Dict[str, list], config: dict, live: float,
               rays: float) -> float:
    """A train step's model FLOPs for ``config``'s model (MLP widths
    ``dims``) at ``live`` samples and ``rays`` rays."""
    if "mlp" in dims:
        return neus_train_step(dims, live)
    geo = config["model"]["geometry"]
    probes = 4 if geo.get("fd_probe_mode", "central6") == "tetra4" else 6
    frac = float(geo.get("curvature_probe_frac", 1.0))
    stride = max(int(round(1.0 / max(frac, 1e-6))), 1)
    return split_train_step(dims, live, rays, probes, stride)
