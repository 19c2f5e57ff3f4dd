"""Weight files: the JAX package's flat '/'-keyed npz, read into PyTorch.

Serving checkpoints are one npz per family with '/'-joined parameter paths
(``enc/0/blocks/1/conv1/w``). Kernels of two or more dimensions are stored
fp16 and biases/norms f32; everything loads as f32. The JAX layouts map onto
the port's modules as:

- conv kernels HWIO ``[kh, kw, ci, co]`` -> OIHW ``[co, ci, kh, kw]``, and
  the last four axes of a stack of them alike (the W-fold's phase kernels
  ``[2, 2, kh, kw, ci, co]``, models/folded.py);
- dense kernels ``[in, out]`` stay ``[in, out]`` (applied as ``x @ w``);
- '/' in a path -> '.' in the state-dict key.

``params_to_jax`` and ``save_params`` go the other way, so a model trained by
the port is written in the layout the JAX package's ``load_params`` reads.
"""

from __future__ import annotations

import io
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
        if arr.ndim >= 4:
            lead = tuple(range(arr.ndim - 4))
            arr = arr.transpose(*lead, *(len(lead) + i for i in (3, 2, 0, 1)))
        state[key.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: a state dict -> flat '/'-keyed
    arrays in the JAX layouts (OIHW -> HWIO), f32 on the host."""
    flat = {}
    for key, value in state.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        if arr.ndim >= 4:
            lead = tuple(range(arr.ndim - 4))
            arr = arr.transpose(*lead, *(len(lead) + i for i in (2, 3, 1, 0)))
        flat[key.replace(".", "/")] = np.ascontiguousarray(arr)
    return flat


def save_params(state: dict[str, torch.Tensor], path: str, half_precision: bool = True) -> None:
    """Write ``state`` as the JAX package's serving npz: the same keys, f32
    arrays of two or more dimensions in fp16 (``half_precision``), the rest
    as they are, compressed. The file is written beside ``path`` and swapped
    in with ``os.replace``: interim exports overwrite the weights a warm
    start reads, and a kill during the write must leave the old file whole."""
    flat = params_to_jax(state)
    if half_precision:
        flat = {k: v.astype(np.float16) if v.dtype == np.float32 and v.ndim >= 2 else v for k, v in flat.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


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
