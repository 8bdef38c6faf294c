"""NN building blocks as ``nn.Module``s (counterpart of ``rise_sdf_tpu/nn.py``).

* ``MLP``: VanillaMLP with geometric (sphere) init, weight norm kept as
  explicit ``v``, ``g``, ``b`` parameters (``w = v * g / max(||v||_row,
  1e-12)``) and Softplus(beta=100) hidden activations.
* ``FrequencyEncoding``: VanillaFrequency sin/cos bands.
* ``spherical_harmonics`` / ``SHEncoding``: real SH basis, inputs in
  [0,1] mapped to [-1,1] (tiny-cuda-nn convention).
* ``CompositeEncoding``: optional xyz prefix, xyz first.

Parameter names follow the JAX pytrees (``layers.<i>.v`` for
``layers/<i>/v``), so ``bridge.py`` maps checkpoints by path.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from . import draws
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------------------- #
# Activations
# --------------------------------------------------------------------------- #


def trunc_exp(x):
    """exp with clamped input for stability."""
    return torch.exp(torch.clamp(x, -15.0, 15.0))


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return lambda x: x
    name = str(name).lower()
    if name in ("none", "identity"):
        return lambda x: x
    if name.startswith("scale"):
        s = float(name[5:])
        return lambda x: torch.clamp(x, 0.0, s) / s
    if name.startswith("clamp"):
        c = float(name[5:])
        return lambda x: torch.clamp(x, 0.0, c)
    if name.startswith("mul"):
        m = float(name[3:])
        return lambda x: x * m
    if name == "lin2srgb":
        return lambda x: torch.clamp(
            torch.where(
                x > 0.0031308,
                torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) * 1.055
                - 0.055,
                12.92 * x,
            ),
            0.0,
            1.0,
        )
    if name == "trunc_exp":
        return trunc_exp
    if name.startswith("+") or name.startswith("-"):
        off = float(name)
        return lambda x: x + off
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return F.relu
    if name == "softplus":
        return F.softplus
    if name == "exp":
        return torch.exp
    raise ValueError(f"Unknown activation '{name}'")


def softplus100(x):
    """Softplus with beta=100 (sphere-init activation)."""
    return F.softplus(100.0 * x) / 100.0


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #


class _Layer(nn.Module):
    """One linear layer: ``{v, g, b}`` (weight norm) or ``{w, b}``."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool):
        super().__init__()
        if weight_norm:
            self.v = nn.Parameter(torch.empty(d_out, d_in))
            self.g = nn.Parameter(torch.empty(d_out))
        else:
            self.w = nn.Parameter(torch.empty(d_out, d_in))
        self.b = nn.Parameter(torch.empty(d_out))

    def weight(self):
        if hasattr(self, "v"):
            norm = torch.linalg.vector_norm(self.v, dim=1, keepdim=True)
            return self.v * (self.g[:, None] / torch.clamp(norm, min=1e-12))
        return self.w

    def forward(self, x):
        return F.linear(x, self.weight(), self.b)


class MLP(nn.Module):
    """VanillaMLP (``rise_sdf_tpu/nn.py:MLP``).  With ``compute_dtype:
    bfloat16`` each layer's input and weight are rounded to bf16 and
    multiplied in float32, then the float32 bias is added, as JAX's
    ``dot_general(..., preferred_element_type=f32)``: a product of two
    bf16 values is exact in float32, so only the summation order
    differs.  (A torch bf16 matmul would round each output to bf16.)
    TF32 must stay off, PyTorch's default for matmuls."""

    def __init__(self, dim_in: int, dim_out: int, config: Dict[str, Any]):
        super().__init__()
        self.dim_in = dim_in
        self.dim_out = dim_out
        self.n_neurons = int(config["n_neurons"])
        self.n_hidden_layers = int(config["n_hidden_layers"])
        self.sphere_init = bool(config.get("sphere_init", False))
        self.sphere_init_radius = float(config.get("sphere_init_radius", 0.5))
        # sphere init with the SDF negative outside the sphere (a scene
        # seen from inside it)
        self.inside_outside = bool(config.get("inside_outside", False))
        self.weight_norm = bool(config.get("weight_norm", False))
        # bf16 products with float32 params, bias and outputs
        self.compute_dtype = {"float32": torch.float32,
                              "bfloat16": torch.bfloat16}[
            str(config.get("compute_dtype", "float32"))]
        self.output_activation = get_activation(config.get("output_activation"))
        self.hidden_activation = softplus100 if self.sphere_init else F.relu
        self.dims = [dim_in] + [self.n_neurons] * self.n_hidden_layers \
            + [dim_out]
        self.layers = nn.ModuleList(
            _Layer(self.dims[i], self.dims[i + 1], self.weight_norm)
            for i in range(len(self.dims) - 1))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Same distributions as the JAX init (not the same numbers)."""
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            d_in, d_out = self.dims[i], self.dims[i + 1]
            normal = lambda *shape: draws.randn(generator, shape)
            dev = draws.device_of(generator)
            w = torch.zeros(d_out, d_in, device=dev)
            b = torch.zeros(d_out, device=dev)
            if self.sphere_init:
                if i == n - 1:
                    mean = math.sqrt(math.pi) / math.sqrt(d_in)
                    sign = -1.0 if self.inside_outside else 1.0
                    w = sign * mean + 1e-4 * normal(d_out, d_in)
                    b.fill_(-sign * self.sphere_init_radius)
                elif i == 0:
                    w[:, :3] = math.sqrt(2.0) / math.sqrt(d_out) \
                        * normal(d_out, 3)
                else:
                    w = math.sqrt(2.0) / math.sqrt(d_out) * normal(d_out, d_in)
            else:
                bound = math.sqrt(6.0 / d_in)
                w = (draws.rand(generator, (d_out, d_in)) * 2.0
                     - 1.0) * bound
            if self.weight_norm:
                layer.v.copy_(w)
                layer.g.copy_(torch.linalg.vector_norm(w, dim=1))
            else:
                layer.w.copy_(w)
            layer.b.copy_(b)

    def forward(self, x):
        h = x
        n = len(self.layers)
        cdt = self.compute_dtype
        for i, layer in enumerate(self.layers):
            if cdt is torch.float32:
                h = layer(h)
            else:
                h = F.linear(h.to(cdt).float(),
                             layer.weight().to(cdt).float()) + layer.b
            if i < n - 1:
                h = self.hidden_activation(h)
        return self.output_activation(h)


# --------------------------------------------------------------------------- #
# Frequency encoding (VanillaFrequency)
# --------------------------------------------------------------------------- #


class Identity(nn.Module):
    """``otype: Identity`` (``rise_sdf_tpu/nn.py:Identity``): no
    parameters, the input as it is (the JAX params subtree is empty)."""

    n_output_dims = None

    def forward(self, x):
        return x


class FrequencyEncoding(nn.Module):
    """sin/cos at frequencies 2^0 .. 2^(n-1), band-major, with the
    optional cosine-window progressive mask over ``n_masking_step``."""

    def __init__(self, in_channels: int, config: Dict[str, Any]):
        super().__init__()
        self.n_freqs = int(config["n_frequencies"])
        self.n_input_dims = in_channels
        self.x_scale = float(config.get("x_scale", 1.0))
        self.x_offset = float(config.get("x_offset", 0.0))
        self.n_masking_step = int(config.get("n_masking_step", 0))
        self.freq_bands = [2.0 ** i for i in range(self.n_freqs)]
        self.n_output_dims = in_channels * 2 * self.n_freqs

    def mask(self, step) -> Optional[torch.Tensor]:
        """[n_freqs] window, or None when masking is off."""
        if self.n_masking_step <= 0:
            return None
        ptr = float(step) / self.n_masking_step * self.n_freqs \
            - torch.arange(self.n_freqs, dtype=torch.float32)
        return (1.0 - torch.cos(math.pi * torch.clamp(ptr, 0.0, 1.0))) / 2.0

    def forward(self, x, step=None, **_kw):
        x = x * self.x_scale + self.x_offset
        mask = self.mask(step if step is not None
                         else self.n_masking_step + 1)
        outs = []
        for i, f in enumerate(self.freq_bands):
            s, c = torch.sin(f * x), torch.cos(f * x)
            if mask is not None:
                m = mask[i].to(x.device)
                s, c = s * m, c * m
            outs += [s, c]
        return torch.cat(outs, dim=-1)


# --------------------------------------------------------------------------- #
# Spherical harmonics encoding (real SH basis, l <= 4)
# --------------------------------------------------------------------------- #


def spherical_harmonics(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis of ``dirs`` [..., 3]; ``degree`` counts bands
    (4 -> 16 outputs, 5 -> 25), tiny-cuda-nn's convention."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    if degree >= 5:
        out += [
            2.5033429417967046 * xy * (xx - yy),
            -1.7701307697799304 * yz * (3.0 * xx - yy),
            0.94617469575756008 * xy * (7.0 * zz - 1.0),
            -0.66904654355728921 * yz * (3.0 - 7.0 * zz),
            -3.1735664074561294 * zz + 3.7024941420321507 * zz * zz
            + 0.31735664074561293,
            -0.66904654355728921 * xz * (3.0 - 7.0 * zz),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            -1.7701307697799304 * xz * (xx - 3.0 * yy),
            0.62583573544917614 * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    if degree >= 6:
        raise NotImplementedError("SH degree > 5 not implemented")
    return torch.stack(out, dim=-1)


class SHEncoding(nn.Module):
    """Direction encoding; input expected in [0,1]^3 (tcnn convention)."""

    def __init__(self, in_channels: int, config: Dict[str, Any]):
        super().__init__()
        assert in_channels == 3
        self.degree = int(config["degree"])
        self.n_input_dims = 3
        self.n_output_dims = self.degree ** 2

    def forward(self, x, step=None, **_kw):
        return spherical_harmonics(x * 2.0 - 1.0, self.degree)


# --------------------------------------------------------------------------- #
# Composite encoding + factories
# --------------------------------------------------------------------------- #


class CompositeEncoding(nn.Module):
    """Optionally prepend (scaled) xyz to the encoded features, xyz first
    (the sphere-init MLP's first layer reads only the first 3 inputs)."""

    def __init__(self, encoding, include_xyz=False, xyz_scale=2.0,
                 xyz_offset=-1.0):
        super().__init__()
        self.encoding = encoding
        self.include_xyz = include_xyz
        self.xyz_scale = xyz_scale
        self.xyz_offset = xyz_offset
        self.n_input_dims = encoding.n_input_dims
        self.n_output_dims = (
            int(include_xyz) * encoding.n_input_dims + encoding.n_output_dims
        )

    def forward(self, x, step=None, **kw):
        enc = self.encoding(x, step, **kw)
        if not self.include_xyz:
            return enc
        return torch.cat([x * self.xyz_scale + self.xyz_offset, enc], dim=-1)


def get_encoding(n_input_dims: int, config) -> CompositeEncoding:
    otype = config["otype"]
    if otype == "VanillaFrequency":
        enc = FrequencyEncoding(n_input_dims, dict(config))
    elif otype == "SphericalHarmonics":
        enc = SHEncoding(n_input_dims, dict(config))
    elif otype in ("ProgressiveBandHashGrid", "HashGrid"):
        from .ops.hashgrid import HashGridEncoding

        enc = HashGridEncoding(n_input_dims, dict(config))
    else:
        raise ValueError(f"Encoding otype '{otype}' is not ported")
    return CompositeEncoding(
        enc,
        include_xyz=bool(config.get("include_xyz", False)),
        xyz_scale=float(config.get("xyz_scale", 2.0)),
        xyz_offset=float(config.get("xyz_offset", -1.0)),
    )


def get_mlp(n_input_dims: int, n_output_dims: int, config) -> nn.Module:
    otype = config["otype"]
    if otype == "VanillaMLP":
        return MLP(n_input_dims, n_output_dims, dict(config))
    if otype == "Identity":
        return Identity()
    raise ValueError(f"Unknown MLP otype '{otype}'")
