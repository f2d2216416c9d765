"""Foundational layers and the parameter-spec system (port of
``repro.models.layers``).

Parameters are declared as :class:`ParamSpec` trees (shape + logical axes
+ init); :func:`init_params` draws a tree of tensors from one, in the JAX
package's layout: nested dicts keyed as its trees are, stacked layer axes
leading, matrices stored ``(in, out)``.  :func:`load_jax_params` carries a
JAX model's weights across as they are.  For the dry run,
:func:`abstract_params` gives the tree as ``meta`` tensors (shapes and
dtypes, no storage) and :func:`param_shardings` the spec of each leaf
under a mesh's rules (``configs.base.mesh_rules``), as the JAX package's
``abstract_params`` / ``param_shardings`` do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import logical_to_spec
from ..core.array_sim.convert import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def fan_in_scale(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return 1.0 / float(np.sqrt(max(1, fan_in)))


ParamTree = Any  # nested dict of ParamSpec / tensors


def tree_paths(specs: ParamTree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` of a nested dict (leaves: ParamSpecs, tensors or
    arrays)."""
    if not isinstance(specs, Mapping):
        return {prefix: specs}
    out: Dict[str, Any] = {}
    for k, v in specs.items():
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(flat: Mapping[str, Any]) -> ParamTree:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def init_params(specs: ParamTree, generator, dtype: torch.dtype,
                device="cuda") -> ParamTree:
    """Draw every leaf of ``specs`` on ``device``, in sorted path order:
    N(0, 1) in f32 times ``fan_in_scale()``, then cast to ``dtype``; zeros
    and ones as declared.  ``generator`` is a ``torch.Generator`` on
    ``device`` or an int seed for one.  The numbers are not the JAX
    package's (another generator); the tests carry JAX weights across with
    :func:`load_jax_params`."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    out: Dict[str, torch.Tensor] = {}
    for path, spec in sorted(tree_paths(specs).items()):
        if spec.init == "zeros":
            arr = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            arr = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            arr = torch.randn(spec.shape, generator=generator,
                              dtype=torch.float32, device=device)
            arr = arr.mul_(spec.fan_in_scale()).to(dtype)
        out[path] = arr
    return unflatten(out)


def abstract_params(specs: ParamTree, dtype: torch.dtype) -> ParamTree:
    """The tree of ``specs`` as ``meta`` tensors of ``dtype``: shapes and
    dtypes with no storage (the JAX ``ShapeDtypeStruct`` tree)."""
    return unflatten({path: torch.empty(spec.shape, dtype=dtype,
                                        device="meta")
                      for path, spec in tree_paths(specs).items()})


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh: a JAX-style one (``axis_names`` and
    ``devices.shape``), the port's ``core.array_sim.Mesh`` or a
    ``launch.mesh.MeshShape`` (``shape`` an axis -> size dict or a tuple)."""
    if hasattr(mesh, "devices"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    shape = mesh.shape
    return dict(shape) if isinstance(shape, dict) \
        else dict(zip(mesh.axis_names, shape))


def param_shardings(specs: ParamTree, rules: Mapping[str, Any],
                    mesh=None) -> ParamTree:
    """The spec of every leaf (``configs.base.logical_to_spec``); with a
    mesh, mesh-axis components that do not divide the tensor dim are
    dropped greedily (e.g. xlstm's 1408-wide FFN keeps "model" 16-way FSDP
    but drops the extra "data" 16-way), as in the JAX package."""
    sizes = mesh_sizes(mesh) if mesh is not None else {}

    def fit(spec: ParamSpec):
        ps = logical_to_spec(spec.logical, rules)
        if not sizes:
            return ps
        fixed = []
        for dim, axis in zip(spec.shape, ps):
            if axis is None:
                fixed.append(None)
                continue
            comps = (axis,) if isinstance(axis, str) else tuple(axis)
            kept = []
            prod = 1
            for c in comps:
                if dim % (prod * sizes.get(c, 1)) == 0:
                    kept.append(c)
                    prod *= sizes.get(c, 1)
            fixed.append(None if not kept else
                         (kept[0] if len(kept) == 1 else tuple(kept)))
        return tuple(fixed)

    return unflatten({path: fit(spec)
                      for path, spec in tree_paths(specs).items()})


def fan_in_rescale(specs: ParamTree, params: ParamTree) -> ParamTree:
    """Rescale, in place, every stacked matrix of ``params`` drawn from
    ``specs`` by :func:`init_params` to N(0, 1 / fan_in) of its own input
    dimension, and return ``params``.  ``fan_in_scale`` reads ``shape[0]``,
    which on a stacked spec is the layer count (the JAX package's draw, kept
    by :func:`init_params`): at full width that draws qwen2's layers at
    1/sqrt(28) where 1/sqrt(1536) was meant, and the activations of Zamba2
    and xLSTM reach ~1e8, too ill-conditioned for an f32 comparison
    (ROADMAP §C)."""
    leaves = tree_paths(params)
    for path, spec in tree_paths(specs).items():
        if spec.init == "normal" and spec.scale is None and len(spec.shape) > 2:
            leaves[path].mul_(float(np.sqrt(spec.shape[0] / spec.shape[-2])))
    return params


def load_jax_params(tree: ParamTree, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> ParamTree:
    """A JAX model's ``params`` given as numpy arrays (``jax.tree.map(
    np.asarray, params)``) as the same tree of tensors on ``device``:
    same paths, same stacked layer axes, same ``(in, out)`` layout; cast to
    ``dtype`` when given."""
    device = resolve_device(device)

    def leaf(x):
        t = torch.from_numpy(np.array(x))          # a copy: never aliases x
        return t.to(device=device, dtype=dtype or t.dtype)
    return unflatten({p: leaf(x) for p, x in tree_paths(tree).items()})


def layer(tree: ParamTree, *idx: int) -> ParamTree:
    """The slice ``[idx]`` of every leaf of a stacked tree (one layer of a
    ``lax.scan``)."""
    if not isinstance(tree, Mapping):
        return tree[idx]
    return {k: layer(v, *idx) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# numeric layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
               ) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: broadcastable to (..., T).  Rotates
    the two halves of the head dimension (not interleaved pairs), as the
    JAX package does."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)             # (Dh/2,)
    angles = positions[..., :, None].float() * freqs          # (...,T,Dh/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (...,T,1,Dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp_specs(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def gated_mlp(params: Mapping[str, torch.Tensor], x: torch.Tensor, act: str
              ) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if act == "geglu":      # jax.nn.gelu(approximate=True)
        h = F.gelu(gate, approximate="tanh") * up
    else:                   # swiglu
        h = F.silu(gate) * up
    return h @ params["w_down"]


def embedding_specs(vocab: int, d_model: int) -> Dict[str, ParamSpec]:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}


def embed_tokens(params: Mapping[str, torch.Tensor], tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Rows of the table.  An id outside the table raises (``jnp.take``
    clamps it)."""
    return params["table"][tokens.long()]

