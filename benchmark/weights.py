"""Where a configuration's weights come from: a file of the repository
(``"weights": "weights/<family>.npz"``), or drawn from a seed by its
reference module's ``init`` (``"weights": {"seed": <n>}``).

Seeded weights are written once per checkout, into
``build/bench-weights/<config>-<key>/`` (the key hashes the family, the
architecture, the seed and the module's source) as ``<family>.npz``, beside
links to every shipped ``weights/*.npz``. The program is pointed at that
directory as a deployment points it at a weights directory
(``IRP_WEIGHTS_DIR``), and the reference reads the same file.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np


def resolve(config: dict, reference, root: str) -> tuple[str, str | None]:
    """(the npz of the configuration's family, the directory to give the
    program as ``IRP_WEIGHTS_DIR``, or None where it reads the shipped
    weights as it does by default)."""
    source = config["weights"]
    if isinstance(source, str):
        return os.path.join(root, source), None
    directory = _seeded_directory(config, reference, root)
    return os.path.join(directory, f"{config['family']}.npz"), directory


def _seeded_directory(config: dict, reference, root: str) -> str:
    """The directory of the configuration's seeded weights, drawn and
    written on the first call in a checkout and found on every later one."""
    seed = int(config["weights"]["seed"])
    with open(reference.__file__, "rb") as f:
        module_source = f.read()
    what = json.dumps({"family": config["family"], "arch": config["arch"], "seed": seed}, sort_keys=True)
    key = hashlib.sha256(what.encode() + module_source).hexdigest()[:16]
    parent = os.path.join(root, "build", "bench-weights")
    directory = os.path.join(parent, f"{config['name']}-{key}")
    if os.path.isdir(directory):
        return directory
    os.makedirs(parent, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=f".{config['name']}-", dir=parent)
    try:
        own = f"{config['family']}.npz"
        arrays = {k: np.asarray(v, dtype=np.float32) for k, v in reference.init(config["arch"], seed).items()}
        np.savez(os.path.join(staging, own), **arrays)
        shipped = os.path.join(root, "weights")
        for name in sorted(os.listdir(shipped)):
            if name.endswith(".npz") and name != own:
                os.symlink(os.path.relpath(os.path.join(shipped, name), directory), os.path.join(staging, name))
        try:
            os.rename(staging, directory)
        except OSError:
            if not os.path.isdir(directory):  # another process's rename won the race otherwise
                raise
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return directory
