"""Weight bridges: the JAX package's parameter tree <-> the port, and the
reference's (sp-uhh/sgmse) Lightning ``.ckpt`` <-> the port's checkpoints.

The JAX ``variables["params"]`` tree, as nested dicts of numpy arrays, maps
onto the port's ``state_dict`` by a mechanical walk, because the port names its
submodules after the Flax tree (``down_0_block0.GroupNorm_0``, ...):

- conv ``kernel`` (HWIO) -> ``weight`` (OIHW), and so the FIR conv's
  ``weight`` (``Conv2d_0``, HWIO in JAX);
- a transposed conv's ``re_kernel``/``im_kernel`` (HWIO) -> ``re_weight``/
  ``im_weight`` (C_in, C_out, kh, kw), as ``F.conv_transpose2d`` takes it;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- GroupNorm and BatchNorm ``scale`` -> ``weight``;
- ``bias``, NIN ``W``/``b``, the Fourier ``W`` and the CbN affine carry over;
- the ``batch_stats`` collection (DCUNet's BatchNorm ``mean``/``var``) ->
  buffers of the same names.

On disk a tree is an ``.npz`` of its leaves under ``/``-joined paths
(``down_0_block0/Conv_0/Conv_0/kernel``), which numpy alone reads and writes;
a model with batch statistics is saved as its JAX ``variables`` dict
(:func:`jax_variables_from_state_dict`), which
:func:`state_dict_from_variables` reads back.

The reference's NCSN++ backbones (``ncsnpp``, ``ncsnpp_v2``, ``ncsnpp_48k``)
hold their modules in one position-indexed list (``all_modules.{i}``, in
construction order, reference ncsnpp.py:107-253). The port's copy of the
NCSN++ half of ``sgmse_tpu/convert.py`` re-derives that order symbolically
(:func:`ncsnpp_module_walk`) and maps each tensor to the Flax tree and back,
unchanged; the tree then goes to the port's names as above. On top of it,
:func:`convert_lightning_checkpoint` imports a Lightning ``.ckpt`` (its
``hyper_parameters``, ``state_dict`` and ``torch_ema`` shadow weights) into a
port checkpoint directory (``checkpoint.py``), and
:func:`export_lightning_checkpoint` writes a port checkpoint as a ``.ckpt``
that the reference loads (``ScoreModel.load_from_checkpoint``):

    python -m sgmse_tpu_torch.convert model.ckpt out_dir    # import
    python -m sgmse_tpu_torch.convert ckpt_dir model.ckpt   # export

The DCUNet half (:func:`convert_dcunet_state_dict`,
:func:`export_dcunet_state_dict`) maps the reference's named modules, its
BatchNorm running statistics and its transposed-conv layouts the same way;
the statistics travel in a port checkpoint's ``model_state``.
"""
from __future__ import annotations

import argparse
import os
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": leaf}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """{"a/b/c": leaf} -> nested dicts."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_npz(path, tree: Mapping) -> None:
    """Write a parameter tree as an .npz of its flattened leaves."""
    np.savez(path, **flatten_tree(tree))


def load_npz(path) -> Dict:
    """Read a parameter tree written by :func:`save_npz`."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


# Leaves that keep their name and layout: NIN's W and b, the Fourier W, the
# complex BatchNorm's (CbN) affine. BatchNorm running statistics (``mean``,
# ``var``) are buffers of the port, the ``batch_stats`` collection in JAX.
_AS_IS = ("bias", "W", "b", "Wrr", "Wri", "Wii", "Br", "Bi")
_STATS = ("mean", "var")


def _leaf_to_port(path: str, name: str, leaf: np.ndarray):
    """(port name, port layout) of one leaf of the JAX parameter tree."""
    if name == "kernel":
        if leaf.ndim == 4:  # HWIO -> OIHW
            return "weight", leaf.transpose(3, 2, 0, 1)
        if leaf.ndim == 2:  # (in, out) -> (out, in)
            return "weight", leaf.T
        raise ValueError(f"{path}: unexpected kernel rank {leaf.ndim}")
    if name == "weight" and leaf.ndim == 4:  # FIRConv2d: HWIO -> OIHW
        return "weight", leaf.transpose(3, 2, 0, 1)
    if name in ("re_kernel", "im_kernel"):  # transposed conv: HWIO -> (I, O, H, W)
        return name[:2] + "_weight", leaf.transpose(2, 3, 0, 1)
    if name == "scale":
        return "weight", leaf
    if name in _AS_IS or name in ("re_bias", "im_bias"):
        return name, leaf
    raise ValueError(f"{path}: unknown parameter name {name!r}")


def state_dict_from_jax(tree: Mapping, batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """Map a JAX parameter tree (and, for a model with BatchNorm, its
    ``batch_stats`` tree) to the port's state_dict names and layouts."""
    sd = {}
    for path, leaf in flatten_tree(tree).items():
        *parents, name = path.split("/")
        name, leaf = _leaf_to_port(path, name, leaf)
        sd[".".join([*parents, name])] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    for path, leaf in flatten_tree(batch_stats or {}).items():
        if path.split("/")[-1] not in _STATS:
            raise ValueError(f"{path}: unknown batch statistic")
        sd[path.replace("/", ".")] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return sd


def state_dict_from_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """:func:`state_dict_from_jax` of a tree that is either a parameter tree or
    a JAX ``variables`` dict (``{"params": ..., "batch_stats": ...}``), as an
    ``.npz`` of :func:`save_npz` holds one."""
    if isinstance(tree.get("params"), Mapping):
        return state_dict_from_jax(tree["params"], tree.get("batch_stats"))
    return state_dict_from_jax(tree)


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                             collection: str = "params") -> Dict:
    """Inverse of :func:`state_dict_from_jax`: the port's parameters as a JAX
    tree (``collection="params"``), or its BatchNorm running statistics as the
    ``batch_stats`` tree (``collection="batch_stats"``)."""
    flat = {}
    for key, value in state_dict.items():
        *parents, name = key.split(".")
        if (name in _STATS) != (collection == "batch_stats"):
            continue
        leaf = value.detach().float().cpu().numpy()
        if name == "weight":
            if leaf.ndim == 4 and parents[-1:] in ([], ["Conv2d_0"]):  # FIRConv2d's "weight"
                leaf = leaf.transpose(2, 3, 1, 0)
            elif leaf.ndim == 4:  # OIHW -> HWIO
                leaf, name = leaf.transpose(2, 3, 1, 0), "kernel"
            elif leaf.ndim == 2:
                leaf, name = leaf.T, "kernel"
            else:  # GroupNorm, BatchNorm
                name = "scale"
        elif name in ("re_weight", "im_weight"):  # transposed conv: (I, O, H, W) -> HWIO
            leaf, name = leaf.transpose(2, 3, 0, 1), name[:2] + "_kernel"
        flat["/".join([*parents, name])] = np.array(leaf, order="C")  # a copy, never a view
    return unflatten_tree(flat)


def jax_variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX ``variables`` dict of a port state_dict: ``params``, and
    ``batch_stats`` where the model has BatchNorm statistics."""
    variables = {"params": jax_tree_from_state_dict(state_dict)}
    stats = jax_tree_from_state_dict(state_dict, "batch_stats")
    if stats:
        variables["batch_stats"] = stats
    return variables


def params_from_jax(tree: Mapping, backbone: str = "ncsnpp", batch_stats: Optional[Mapping] = None,
                    **config) -> Dict[str, torch.Tensor]:
    """JAX ``variables["params"]`` (and ``variables["batch_stats"]``) of the
    ``backbone`` network built with ``config`` -> the port's state_dict.
    Strict-loads it into the registry's class for ``backbone`` first, so a
    leaf left over, missing or of the wrong shape raises."""
    from .models import BackboneRegistry

    sd = state_dict_from_jax(tree, batch_stats)
    BackboneRegistry.get_by_name(backbone)(**config).load_state_dict(sd, strict=True)
    return sd


# ---------------------------------------------------------------------------------------
# NCSN++ family: the reference's construction-order walk <-> the Flax tree
# ---------------------------------------------------------------------------------------

def _t_linear(w):
    return np.ascontiguousarray(np.transpose(w, (1, 0)))


def _t_conv(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _set(tree: Dict, path: Path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def ncsnpp_module_walk(
    nf: int = 128,
    ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
    num_res_blocks: int = 2,
    attn_resolutions: Sequence[int] = (16,),
    image_size: int = 256,
    conditional: bool = True,
    embedding_type: str = "fourier",
    resblock_type: str = "biggan",
    progressive: str = "output_skip",
    progressive_input: str = "input_skip",
    progressive_combine: str = "sum",
    **ignored,
) -> List[Tuple[int, str, str]]:
    """(reference module index, Flax module name, kind) in construction order.
    Attention sits where ``image_size // 2**level`` is in ``attn_resolutions``."""
    out: List[Tuple[int, str, str]] = []
    idx = 0
    num_resolutions = len(ch_mult)
    all_resolutions = [image_size // (2**i) for i in range(num_resolutions)]

    if embedding_type == "fourier":
        out.append((idx, "fourier", "gfp")); idx += 1
    if conditional:
        out.append((idx, "temb_dense0", "linear")); idx += 1
        out.append((idx, "temb_dense1", "linear")); idx += 1

    out.append((idx, "conv_in", "conv")); idx += 1

    for i_level in range(num_resolutions):
        for i_block in range(num_res_blocks):
            out.append((idx, f"down_{i_level}_block{i_block}", "resblock")); idx += 1
            if all_resolutions[i_level] in attn_resolutions:
                out.append((idx, f"down_{i_level}_attn{i_block}", "attn")); idx += 1
        if i_level != num_resolutions - 1:
            if resblock_type == "ddpm":
                out.append((idx, f"down_{i_level}_downsample", "updown")); idx += 1
            else:
                out.append((idx, f"down_{i_level}_downres", "resblock")); idx += 1
            if progressive_input == "input_skip":
                out.append((idx, f"down_{i_level}_combine", "combine")); idx += 1
            elif progressive_input == "residual":
                out.append((idx, f"down_{i_level}_pyramid_down", "firconv")); idx += 1

    out.append((idx, "mid_block0", "resblock")); idx += 1
    out.append((idx, "mid_attn", "attn")); idx += 1
    out.append((idx, "mid_block1", "resblock")); idx += 1

    for i_level in reversed(range(num_resolutions)):
        for i_block in range(num_res_blocks + 1):
            out.append((idx, f"up_{i_level}_block{i_block}", "resblock")); idx += 1
        if all_resolutions[i_level] in attn_resolutions:
            out.append((idx, f"up_{i_level}_attn", "attn")); idx += 1
        if progressive != "none":
            if i_level == num_resolutions - 1:
                out.append((idx, f"up_{i_level}_pyramid_norm", "groupnorm")); idx += 1
                out.append((idx, f"up_{i_level}_pyramid_conv", "conv")); idx += 1
            else:
                if progressive == "output_skip":
                    out.append((idx, f"up_{i_level}_pyramid_norm", "groupnorm")); idx += 1
                    out.append((idx, f"up_{i_level}_pyramid_conv", "conv")); idx += 1
                elif progressive == "residual":
                    out.append((idx, f"up_{i_level}_pyramid_up", "firconv")); idx += 1
        if i_level != 0:
            if resblock_type == "ddpm":
                out.append((idx, f"up_{i_level}_upsample", "updown")); idx += 1
            else:
                out.append((idx, f"up_{i_level}_upres", "resblock")); idx += 1

    if progressive != "output_skip":
        out.append((idx, "out_norm", "groupnorm")); idx += 1
        out.append((idx, "out_conv", "conv")); idx += 1
    return out


def _expand_kind(prefix: str, name: str, kind: str, sd: Dict[str, np.ndarray],
                 params: Dict) -> List[str]:
    """Copy all tensors of reference module `prefix` (e.g. 'all_modules.7') into
    the `params` tree under module `name`. Returns the consumed reference keys."""
    used = []

    def take(suffix):
        key = f"{prefix}.{suffix}"
        if key in sd:
            used.append(key)
            return np.asarray(sd[key])
        return None

    if kind == "gfp":
        _set(params, (name, "W"), take("W"))
    elif kind == "linear":
        _set(params, (name, "Dense_0", "kernel"), _t_linear(take("weight")))
        _set(params, (name, "Dense_0", "bias"), take("bias"))
    elif kind == "conv":
        _set(params, (name, "Conv_0", "kernel"), _t_conv(take("weight")))
        b = take("bias")
        if b is not None:
            _set(params, (name, "Conv_0", "bias"), b)
    elif kind == "groupnorm":
        _set(params, (name, "scale"), take("weight"))
        _set(params, (name, "bias"), take("bias"))
    elif kind == "attn":
        _set(params, (name, "GroupNorm_0", "scale"), take("GroupNorm_0.weight"))
        _set(params, (name, "GroupNorm_0", "bias"), take("GroupNorm_0.bias"))
        for k in range(4):
            _set(params, (name, f"NIN_{k}", "W"), take(f"NIN_{k}.W"))
            _set(params, (name, f"NIN_{k}", "b"), take(f"NIN_{k}.b"))
    elif kind == "resblock":
        _set(params, (name, "GroupNorm_0", "scale"), take("GroupNorm_0.weight"))
        _set(params, (name, "GroupNorm_0", "bias"), take("GroupNorm_0.bias"))
        _set(params, (name, "Conv_0", "Conv_0", "kernel"), _t_conv(take("Conv_0.weight")))
        _set(params, (name, "Conv_0", "Conv_0", "bias"), take("Conv_0.bias"))
        w = take("Dense_0.weight")
        if w is not None:
            _set(params, (name, "Dense_0", "Dense_0", "kernel"), _t_linear(w))
            _set(params, (name, "Dense_0", "Dense_0", "bias"), take("Dense_0.bias"))
        _set(params, (name, "GroupNorm_1", "scale"), take("GroupNorm_1.weight"))
        _set(params, (name, "GroupNorm_1", "bias"), take("GroupNorm_1.bias"))
        _set(params, (name, "Conv_1", "Conv_0", "kernel"), _t_conv(take("Conv_1.weight")))
        _set(params, (name, "Conv_1", "Conv_0", "bias"), take("Conv_1.bias"))
        w = take("Conv_2.weight")  # BigGAN 1x1 shortcut
        if w is not None:
            _set(params, (name, "Conv_2", "Conv_0", "kernel"), _t_conv(w))
            _set(params, (name, "Conv_2", "Conv_0", "bias"), take("Conv_2.bias"))
        w = take("NIN_0.W")  # DDPM-style NIN shortcut
        if w is not None:
            _set(params, (name, "NIN_0", "W"), w)
            _set(params, (name, "NIN_0", "b"), take("NIN_0.b"))
    elif kind == "combine":
        _set(params, (name, "Conv_0", "Conv_0", "kernel"), _t_conv(take("Conv_0.weight")))
        _set(params, (name, "Conv_0", "Conv_0", "bias"), take("Conv_0.bias"))
    elif kind == "firconv":
        _set(params, (name, "Conv2d_0", "weight"), _t_conv(take("Conv2d_0.weight")))
        _set(params, (name, "Conv2d_0", "bias"), take("Conv2d_0.bias"))
    elif kind == "updown":
        _set(params, (name, "Conv_0", "Conv_0", "kernel"), _t_conv(take("Conv_0.weight")))
        _set(params, (name, "Conv_0", "Conv_0", "bias"), take("Conv_0.bias"))
    else:
        raise ValueError(f"unknown kind {kind}")
    return used


def convert_ncsnpp_state_dict(sd: Dict[str, np.ndarray], **config) -> Dict[str, Any]:
    """A reference NCSN++(-v2/-48k) backbone state_dict (keys
    ``all_modules.{i}.*`` + ``output_layer.*``) -> the JAX parameter tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict[str, Any] = {}
    used = set()
    for idx, name, kind in ncsnpp_module_walk(**config):
        used.update(_expand_kind(f"all_modules.{idx}", name, kind, sd, params))
    _set(params, ("output_layer", "kernel"), _t_conv(sd["output_layer.weight"]))
    _set(params, ("output_layer", "bias"), sd["output_layer.bias"])
    used.update(["output_layer.weight", "output_layer.bias"])
    missed = [k for k in sd if k not in used]
    if missed:
        raise ValueError(f"unconverted torch keys: {missed[:10]} (+{max(0, len(missed)-10)} more)")
    return params


def _ti_linear(w):
    """(in, out) -> torch Linear (out, in)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (1, 0)))


def _ti_conv(w):
    """(kh, kw, in, out) -> torch Conv (out, in, kh, kw)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


class _TreeReader:
    """Reads leaves out of a nested params dict, tracking consumption so the
    exporter can prove it visited every parameter."""

    def __init__(self, tree: Dict):
        self.tree = tree
        self.consumed: set = set()

    def get(self, path: Path):
        node = self.tree
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return None
            node = node[p]
        self.consumed.add(path)
        return np.asarray(node)

    def unconsumed(self) -> List[Path]:
        out = []

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, prefix + (k,))
            elif prefix not in self.consumed:
                out.append(prefix)

        walk(self.tree, ())
        return out


def _collect_kind(prefix: str, name: str, kind: str, reader: _TreeReader,
                  sd: Dict[str, np.ndarray]) -> None:
    """Inverse of `_expand_kind`: copy module `name`'s tensors into reference
    keys under `prefix` (e.g. 'all_modules.7')."""

    def put(suffix, value):
        if value is not None:
            sd[f"{prefix}.{suffix}"] = value

    def g(*path):
        return reader.get((name,) + path)

    if kind == "gfp":
        put("W", g("W"))
    elif kind == "linear":
        put("weight", _ti_linear(g("Dense_0", "kernel")))
        put("bias", g("Dense_0", "bias"))
    elif kind == "conv":
        put("weight", _ti_conv(g("Conv_0", "kernel")))
        put("bias", g("Conv_0", "bias"))
    elif kind == "groupnorm":
        put("weight", g("scale"))
        put("bias", g("bias"))
    elif kind == "attn":
        put("GroupNorm_0.weight", g("GroupNorm_0", "scale"))
        put("GroupNorm_0.bias", g("GroupNorm_0", "bias"))
        for k in range(4):
            put(f"NIN_{k}.W", g(f"NIN_{k}", "W"))
            put(f"NIN_{k}.b", g(f"NIN_{k}", "b"))
    elif kind == "resblock":
        put("GroupNorm_0.weight", g("GroupNorm_0", "scale"))
        put("GroupNorm_0.bias", g("GroupNorm_0", "bias"))
        put("Conv_0.weight", _ti_conv(g("Conv_0", "Conv_0", "kernel")))
        put("Conv_0.bias", g("Conv_0", "Conv_0", "bias"))
        w = g("Dense_0", "Dense_0", "kernel")
        if w is not None:
            put("Dense_0.weight", _ti_linear(w))
            put("Dense_0.bias", g("Dense_0", "Dense_0", "bias"))
        put("GroupNorm_1.weight", g("GroupNorm_1", "scale"))
        put("GroupNorm_1.bias", g("GroupNorm_1", "bias"))
        put("Conv_1.weight", _ti_conv(g("Conv_1", "Conv_0", "kernel")))
        put("Conv_1.bias", g("Conv_1", "Conv_0", "bias"))
        w = g("Conv_2", "Conv_0", "kernel")  # BigGAN 1x1 shortcut
        if w is not None:
            put("Conv_2.weight", _ti_conv(w))
            put("Conv_2.bias", g("Conv_2", "Conv_0", "bias"))
        w = g("NIN_0", "W")  # DDPM-style NIN shortcut
        if w is not None:
            put("NIN_0.W", w)
            put("NIN_0.b", g("NIN_0", "b"))
    elif kind == "combine":
        put("Conv_0.weight", _ti_conv(g("Conv_0", "Conv_0", "kernel")))
        put("Conv_0.bias", g("Conv_0", "Conv_0", "bias"))
    elif kind == "firconv":
        put("Conv2d_0.weight", _ti_conv(g("Conv2d_0", "weight")))
        put("Conv2d_0.bias", g("Conv2d_0", "bias"))
    elif kind == "updown":
        put("Conv_0.weight", _ti_conv(g("Conv_0", "Conv_0", "kernel")))
        put("Conv_0.bias", g("Conv_0", "Conv_0", "bias"))
    else:
        raise ValueError(f"unknown kind {kind}")


def export_ncsnpp_state_dict(params: Dict[str, Any], **config) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_ncsnpp_state_dict`: the JAX parameter tree ->
    a reference NCSN++(-v2/-48k) backbone state_dict, in the reference's
    registration order (``output_layer`` first, then ``all_modules`` in walk
    order), which ``torch_ema`` relies on to pair ``shadow_params`` with
    parameters. Pass ``image_size`` equal to the STFT's ``n_fft // 2 + 1``,
    where the model's attention sits (:func:`export_lightning_checkpoint`
    does)."""
    reader = _TreeReader(params)
    sd: Dict[str, np.ndarray] = {}
    sd["output_layer.weight"] = _ti_conv(reader.get(("output_layer", "kernel")))
    sd["output_layer.bias"] = reader.get(("output_layer", "bias"))
    for idx, name, kind in ncsnpp_module_walk(**config):
        _collect_kind(f"all_modules.{idx}", name, kind, reader, sd)
    missed = reader.unconsumed()
    if missed:
        raise ValueError(
            f"unexported param leaves: {missed[:10]} (+{max(0, len(missed)-10)} more)")
    return sd


# ---------------------------------------------------------------------------------------
# DCUNet: the reference's module names <-> the Flax tree (params and batch_stats)
# ---------------------------------------------------------------------------------------

def _t_convT(w):
    """torch ConvTranspose (in, out, kh, kw) -> (kh, kw, in, out)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


_ti_convT = _t_convT  # the same permutation back: (kh, kw, in, out) -> (in, out, kh, kw)


def _dcunet_layout(dcunet_architecture: str = "DilDCUNet-v2", dcunet_time_embedding: str = "gfp",
                   dcunet_temb_layers_global: int = 2, dcunet_temb_layers_local: int = 1,
                   **ignored):
    """(encoder count, decoder count, time embedding, global and local layers)."""
    from .models.dcunet import DCUNET_ARCHITECTURES

    encoders, decoders = DCUNET_ARCHITECTURES[dcunet_architecture]
    return (len(encoders), len(decoders) - 1, dcunet_time_embedding, dcunet_temb_layers_global,
            dcunet_temb_layers_local)


def convert_dcunet_state_dict(sd: Dict[str, np.ndarray], **config
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference DCUNet state_dict -> the JAX (params, batch_stats) trees:
    complex convs (``{re,im}_module``), transposed ones (``re_kernel`` /
    ``im_kernel`` in direct form), ``bN`` norms with their running statistics
    (``num_batches_tracked`` is dropped) or ``CbN`` affines, and the time
    embedding (``embed.0`` the Fourier or diffusion-step embedding, then
    (linear, activation) pairs; per block ``embed_layer``)."""
    n_enc, n_dec, temb, n_global, n_local = _dcunet_layout(**config)
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    used = set()

    def take(key):
        used.add(key)
        return sd[key]

    def maybe(key):
        return take(key) if key in sd else None

    if temb != "none":
        w = maybe("embed.0.W")
        if w is not None:
            _set(params, ("embed_gfp" if temb == "gfp" else "embed_ds", "W"), w)
        for i in range(n_global):
            for part in ("re", "im"):
                _set(params, (f"embed_global{i}", part, "kernel"),
                     _t_linear(take(f"embed.{1 + 2 * i}.{part}.weight")))
                _set(params, (f"embed_global{i}", part, "bias"),
                     take(f"embed.{1 + 2 * i}.{part}.bias"))

    def complex_conv(tprefix, path, transposed=False):
        for part in ("re", "im"):
            w = take(f"{tprefix}.{part}_module.weight")
            b = maybe(f"{tprefix}.{part}_module.bias")
            if transposed:
                _set(params, path + (f"{part}_kernel",), _t_convT(w))
                if b is not None:
                    _set(params, path + (f"{part}_bias",), b)
            else:
                _set(params, path + (part, "kernel"), _t_conv(w))
                if b is not None:
                    _set(params, path + (part, "bias"), b)

    def norm(tprefix, path):
        if f"{tprefix}.re_module.weight" in sd:  # bN
            for part in ("re", "im"):
                _set(params, path + (part, "scale"), take(f"{tprefix}.{part}_module.weight"))
                _set(params, path + (part, "bias"), take(f"{tprefix}.{part}_module.bias"))
                _set(stats, path + (part, "mean"),
                     take(f"{tprefix}.{part}_module.running_mean"))
                _set(stats, path + (part, "var"), take(f"{tprefix}.{part}_module.running_var"))
                maybe(f"{tprefix}.{part}_module.num_batches_tracked")
        else:  # CbN
            for p in ("Wrr", "Wri", "Wii", "Br", "Bi"):
                _set(params, path + (p,), take(f"{tprefix}.{p}"))

    def embed_layer(tprefix, path):
        for i in range(max(0, n_local - 1)):
            for part in ("re", "im"):
                _set(params, path + (f"lin{i}", part, "kernel"),
                     _t_linear(take(f"{tprefix}.{2 * i}.{part}.weight")))
                _set(params, path + (f"lin{i}", part, "bias"),
                     take(f"{tprefix}.{2 * i}.{part}.bias"))
        f = 2 * max(0, n_local - 1)
        for part in ("re", "im"):
            _set(params, path + ("feature_dense", part, "kernel"),
                 _t_linear(take(f"{tprefix}.{f}.dense.{part}.weight")))
            _set(params, path + ("feature_dense", part, "bias"),
                 take(f"{tprefix}.{f}.dense.{part}.bias"))

    for kind, n, conv in (("encoder", n_enc, "conv"), ("decoder", n_dec, "deconv")):
        for i in range(n):
            complex_conv(f"{kind}s.{i}.{conv}", (f"{kind}{i}", conv), transposed=conv == "deconv")
            norm(f"{kind}s.{i}.norm", (f"{kind}{i}", "norm"))
            if temb != "none":
                embed_layer(f"{kind}s.{i}.embed_layer", (f"{kind}{i}", "embed_layer"))
    complex_conv("output_layer", ("output_layer",), transposed=True)
    missed = [k for k in sd if k not in used]
    if missed:
        raise ValueError(f"unconverted torch keys: {missed[:10]} (+{max(0, len(missed)-10)} more)")
    return params, stats


def export_dcunet_state_dict(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]] = None,
                             **config) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_dcunet_state_dict`: the JAX (params,
    batch_stats) trees -> a reference DCUNet state_dict, in the reference's
    registration order, with the ``num_batches_tracked`` counters (0) that
    torch's strict load expects."""
    n_enc, n_dec, temb, n_global, n_local = _dcunet_layout(**config)
    reader, stats = _TreeReader(params), _TreeReader(batch_stats or {})
    sd: Dict[str, np.ndarray] = {}

    if temb != "none":
        w = reader.get(("embed_gfp" if temb == "gfp" else "embed_ds", "W"))
        if w is not None:
            sd["embed.0.W"] = w
        for i in range(n_global):
            for part in ("re", "im"):
                sd[f"embed.{1 + 2 * i}.{part}.weight"] = _ti_linear(
                    reader.get((f"embed_global{i}", part, "kernel")))
                sd[f"embed.{1 + 2 * i}.{part}.bias"] = reader.get((f"embed_global{i}", part,
                                                                   "bias"))

    def complex_conv(tprefix, path, transposed=False):
        for part in ("re", "im"):
            if transposed:
                w, b = (reader.get(path + (f"{part}_kernel",)),
                        reader.get(path + (f"{part}_bias",)))
            else:
                w, b = reader.get(path + (part, "kernel")), reader.get(path + (part, "bias"))
            sd[f"{tprefix}.{part}_module.weight"] = (_ti_convT if transposed else _ti_conv)(w)
            if b is not None:
                sd[f"{tprefix}.{part}_module.bias"] = b

    def norm(tprefix, path):
        if reader.get(path + ("re", "scale")) is not None:  # bN
            for part in ("re", "im"):
                sd[f"{tprefix}.{part}_module.weight"] = reader.get(path + (part, "scale"))
                sd[f"{tprefix}.{part}_module.bias"] = reader.get(path + (part, "bias"))
                sd[f"{tprefix}.{part}_module.running_mean"] = stats.get(path + (part, "mean"))
                sd[f"{tprefix}.{part}_module.running_var"] = stats.get(path + (part, "var"))
                sd[f"{tprefix}.{part}_module.num_batches_tracked"] = np.asarray(0, np.int64)
        else:  # CbN
            for p in ("Wrr", "Wri", "Wii", "Br", "Bi"):
                sd[f"{tprefix}.{p}"] = reader.get(path + (p,))

    def embed_layer(tprefix, path):
        for i in range(max(0, n_local - 1)):
            for part in ("re", "im"):
                sd[f"{tprefix}.{2 * i}.{part}.weight"] = _ti_linear(
                    reader.get(path + (f"lin{i}", part, "kernel")))
                sd[f"{tprefix}.{2 * i}.{part}.bias"] = reader.get(path + (f"lin{i}", part,
                                                                          "bias"))
        f = 2 * max(0, n_local - 1)
        for part in ("re", "im"):
            sd[f"{tprefix}.{f}.dense.{part}.weight"] = _ti_linear(
                reader.get(path + ("feature_dense", part, "kernel")))
            sd[f"{tprefix}.{f}.dense.{part}.bias"] = reader.get(path + ("feature_dense", part,
                                                                        "bias"))

    for kind, n, conv in (("encoder", n_enc, "conv"), ("decoder", n_dec, "deconv")):
        for i in range(n):
            complex_conv(f"{kind}s.{i}.{conv}", (f"{kind}{i}", conv), transposed=conv == "deconv")
            norm(f"{kind}s.{i}.norm", (f"{kind}{i}", "norm"))
            if temb != "none":
                embed_layer(f"{kind}s.{i}.embed_layer", (f"{kind}{i}", "embed_layer"))
    complex_conv("output_layer", ("output_layer",), transposed=True)
    missed = reader.unconsumed() + stats.unconsumed()
    if missed:
        raise ValueError(
            f"unexported param leaves: {missed[:10]} (+{max(0, len(missed)-10)} more)")
    return sd


# ---------------------------------------------------------------------------------------
# Lightning .ckpt <-> the port's checkpoint directories
# ---------------------------------------------------------------------------------------

# hyper_parameters of a reference .ckpt that are no model settings
_NOT_MODEL_HPARAMS = ("backbone", "sde", "data_module_cls", "no_wandb", "gpu", "gpus")


def _is_fourier_w(key: str) -> bool:
    """The Fourier projection's W (a buffer in the reference: requires_grad=False)."""
    return key.endswith(".W") and ("all_modules.0" in key or "embed.0" in key)


def _trainable(sd: Mapping[str, Any]) -> List[str]:
    """The keys ``torch_ema`` shadows, in registration order."""
    return [k for k in sd
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))
            and not _is_fourier_w(k)]


def _check_backbone(backbone: str) -> None:
    if backbone not in ("ncsnpp", "ncsnpp_v2", "ncsnpp_48k", "dcunet"):
        raise NotImplementedError(f"backbone {backbone!r}: only the NCSN++ family and DCUNet "
                                  "convert")


def _reference_sd(backbone: str, port_sd: Mapping[str, torch.Tensor], config
                  ) -> Dict[str, np.ndarray]:
    """A port state_dict (its buffers included) as the reference's backbone
    state_dict."""
    params = jax_tree_from_state_dict(port_sd)
    if backbone == "dcunet":
        return export_dcunet_state_dict(params, jax_tree_from_state_dict(port_sd, "batch_stats"),
                                        **config)
    return export_ncsnpp_state_dict(params, **config)


def export_lightning_checkpoint(port_ckpt_dir, out_path) -> Dict[str, Any]:
    """Write the port checkpoint directory ``port_ckpt_dir`` (``state.pt`` +
    ``config.json``) as a reference Lightning ``.ckpt`` at ``out_path``:
    ``state_dict`` (``dnn.``-prefixed, registration order), ``hyper_parameters``
    (the config, with ``image_size`` = ``n_fft // 2 + 1``, where the model's
    attention sits), ``global_step``, ``epoch`` and the ``torch_ema`` entry
    ``ema`` whose ``shadow_params`` follow the trainable parameters'
    registration order. Returns the checkpoint dict written."""
    from .checkpoint import load_checkpoint

    state, config = load_checkpoint(port_ckpt_dir)
    backbone = config.get("backbone", "ncsnpp")
    _check_backbone(backbone)
    if backbone != "dcunet":
        config = dict(config, image_size=int(config.get("n_fft", 510)) // 2 + 1)
    model_state = state.get("model_state", {})

    def to_reference(port_sd):
        sd = _reference_sd(backbone, {**port_sd, **model_state}, config)
        return {f"dnn.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    sd = to_reference(state["params"])
    ckpt = {"state_dict": sd, "hyper_parameters": dict(config),
            "global_step": int(state.get("step", 0)), "epoch": 0,
            "pytorch_lightning_version": "2.0.0"}
    if state.get("ema_params") is not None:
        ema_sd = to_reference(state["ema_params"])
        ckpt["ema"] = {"decay": float(config.get("ema_decay", 0.999)),
                       "num_updates": int(state.get("num_updates", state.get("step", 0))),
                       "shadow_params": [ema_sd[k] for k in _trainable(sd)],
                       "collected_params": None}
    torch.save(ckpt, out_path)
    return ckpt


def convert_lightning_checkpoint(ckpt_path, out_dir=None):
    """Import a reference Lightning ``.ckpt``: the model is built from its
    ``hyper_parameters`` (settings the model does not take are ignored), the
    backbone weights are walked with the checkpoint's own ``image_size``, and
    the ``torch_ema`` ``shadow_params`` are paired with the trainable
    parameters by registration order (they become the EMA weights; without
    them, or with a count that does not match, the EMA weights are the
    weights). ``pesq_loss.*`` entries are dropped. Writes a port checkpoint
    directory to ``out_dir`` when given. Returns the ``ScoreModel``, on the
    CPU, holding the EMA weights."""
    from .checkpoint import save_checkpoint
    from .model import ScoreModel

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    hparams = dict(ckpt.get("hyper_parameters", {}))
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in ckpt["state_dict"].items() if not k.startswith("pesq_loss.")}
    backbone = hparams.get("backbone", "ncsnpp")
    _check_backbone(backbone)
    model = ScoreModel(backbone, hparams.get("sde", "ouve"),
                       **{k: v for k, v in hparams.items() if k not in _NOT_MODEL_HPARAMS})
    buffers = set(dict(model.dnn.named_buffers()))

    def to_port(reference_sd):
        dnn = {k[len("dnn."):]: v for k, v in reference_sd.items() if k.startswith("dnn.")}
        if backbone == "dcunet":
            port_sd = state_dict_from_jax(*convert_dcunet_state_dict(dnn, **hparams))
        else:
            port_sd = state_dict_from_jax(convert_ncsnpp_state_dict(dnn, **hparams))
        model.dnn.load_state_dict(port_sd, strict=True)  # raises on a leaf left over or missing
        return {k: port_sd[k] for k in model.dnn.state_dict()}  # the port's own order

    params = to_port(sd)
    ema_params = params
    shadow = (ckpt.get("ema") or {}).get("shadow_params")
    if shadow is not None:
        trainable = _trainable(sd)
        if len(shadow) == len(trainable):
            ema_params = to_port(dict(sd, **{k: np.asarray(v) for k, v in zip(trainable, shadow)}))
        else:
            warnings.warn(f"EMA shadow_params count {len(shadow)} != trainable params "
                          f"{len(trainable)}; skipping EMA conversion.")
    model.dnn.load_state_dict(ema_params, strict=True)
    step = int(ckpt.get("global_step", 0))
    if out_dir is not None:
        tree = {"step": step, "params": {k: v for k, v in params.items() if k not in buffers},
                "ema_params": {k: v for k, v in ema_params.items() if k not in buffers},
                "num_updates": step}
        if buffers:
            tree["model_state"] = {k: params[k] for k in params if k in buffers}
        save_checkpoint(out_dir, tree, model.config_dict())
    return model


def main(argv=None) -> None:
    """``python -m sgmse_tpu_torch.convert <in> <out>``: a ``.ckpt`` file in
    imports it to the port checkpoint directory <out>; a port checkpoint
    directory in exports it to the ``.ckpt`` <out>."""
    parser = argparse.ArgumentParser(
        description="Two-way sp-uhh/sgmse Lightning .ckpt <-> port checkpoint converter "
                    "(NCSN++ family and DCUNet): a .ckpt file in is imported to a checkpoint "
                    "directory, a checkpoint directory in is exported to a .ckpt.")
    parser.add_argument("input", help="Lightning .ckpt file or port checkpoint directory")
    parser.add_argument("out", help="output checkpoint directory or .ckpt path")
    args = parser.parse_args(argv)
    if os.path.isdir(args.input):
        export_lightning_checkpoint(args.input, args.out)
        print(f"Exported {args.input} -> {args.out} (Lightning .ckpt)")
    else:
        model = convert_lightning_checkpoint(args.input, out_dir=args.out)
        print(f"Converted {args.input} -> {args.out} "
              f"(backbone={model.backbone}, sde={model.sde_name})")


if __name__ == "__main__":
    main()
