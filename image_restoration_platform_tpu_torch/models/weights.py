"""Weight files: the JAX package's flat '/'-keyed npz, read into PyTorch.

Serving checkpoints are one npz per family with '/'-joined parameter paths
(``enc/0/blocks/1/conv1/w``). Kernels of two or more dimensions are stored
fp16 and biases/norms f32; everything loads as f32. The JAX layouts map onto
the port's modules as:

- conv kernels HWIO ``[kh, kw, ci, co]`` -> OIHW ``[co, ci, kh, kw]``;
- dense kernels ``[in, out]`` stay ``[in, out]`` (applied as ``x @ w``);
- '/' in a path -> '.' in the state-dict key.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def flatten_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict/list parameter tree -> flat {'a/0/b': ndarray}."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            out.update(flatten_params(value, f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            out.update(flatten_params(value, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX parameters (npz contents or ``flatten_params(unet.init(...))``)
    -> a state dict for the port's modules, f32 on the CPU."""
    state = {}
    for key, value in flat.items():
        arr = np.array(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        state[key.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    return params_from_jax(load_npz(path))


def default_weights_dir() -> str:
    return os.environ.get(
        "IRP_WEIGHTS_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "weights"),
    )


def weights_path(family_name: str) -> str:
    return os.path.join(default_weights_dir(), f"{family_name}.npz")
