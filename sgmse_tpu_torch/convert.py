"""Weight bridge between the JAX package's parameter tree and the port.

The JAX ``variables["params"]`` tree, as nested dicts of numpy arrays, maps
onto the port's ``state_dict`` by a mechanical walk, because the port names its
submodules after the Flax tree (``down_0_block0.GroupNorm_0``, ...):

- conv ``kernel`` (HWIO) -> ``weight`` (OIHW);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- GroupNorm ``scale`` -> ``weight``;
- ``bias``, NIN ``W``/``b`` and the Fourier ``W`` carry over as they are.

On disk a tree is an ``.npz`` of its leaves under ``/``-joined paths
(``down_0_block0/Conv_0/Conv_0/kernel``), which numpy alone reads and writes.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map a JAX parameter tree to the port's state_dict names and layouts."""
    sd = {}
    for path, leaf in flatten_tree(tree).items():
        *parents, name = path.split("/")
        if name == "kernel":
            if leaf.ndim == 4:  # HWIO -> OIHW
                leaf = leaf.transpose(3, 2, 0, 1)
            elif leaf.ndim == 2:  # (in, out) -> (out, in)
                leaf = leaf.T
            else:
                raise ValueError(f"{path}: unexpected kernel rank {leaf.ndim}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name not in ("bias", "W", "b"):
            raise ValueError(f"{path}: unknown parameter name {name!r}")
        sd[".".join([*parents, name])] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return sd


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`state_dict_from_jax`: the port's parameters as a JAX tree."""
    flat = {}
    for key, value in state_dict.items():
        *parents, name = key.split(".")
        leaf = value.detach().float().cpu().numpy()
        if name == "weight":
            if leaf.ndim == 4:  # OIHW -> HWIO
                leaf, name = leaf.transpose(2, 3, 1, 0), "kernel"
            elif leaf.ndim == 2:
                leaf, name = leaf.T, "kernel"
            else:  # GroupNorm
                name = "scale"
        flat["/".join([*parents, name])] = np.ascontiguousarray(leaf)
    return unflatten_tree(flat)


def params_from_jax(tree: Mapping, backbone: str = "ncsnpp", **config) -> Dict[str, torch.Tensor]:
    """JAX ``variables["params"]`` of the ``backbone`` network built with
    ``config`` -> the port's state_dict. Strict-loads it into the registry's
    class for ``backbone`` first, so a leaf left over, missing or of the wrong
    shape raises."""
    from .models import BackboneRegistry

    sd = state_dict_from_jax(tree)
    BackboneRegistry.get_by_name(backbone)(**config).load_state_dict(sd, strict=True)
    return sd
