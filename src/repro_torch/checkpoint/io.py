"""Pytree snapshots on npz, counterpart of `repro/checkpoint/io.py`.

Nested dicts/lists of tensors (or arrays) <-> flat npz keys joined with
'/'. List indices are stored as '#i' components, so dict keys that look
numeric (the transformer's segment indices) round-trip as dicts, not lists.
The file format is the reference's, so a snapshot written by either
package loads in the other: bfloat16 leaves are stored as uint16 bit views
listed under ``__bf16_keys__`` (npz cannot hold bf16), and nothing here
needs `ml_dtypes`.

Durability: `save_pytree` writes to a temporary file in the SAME directory
and renames it over the destination (`os.replace`), so a crash or kill
mid-write never leaves a torn snapshot; the previous one at that path
survives intact. `checkpoint.run_state` builds resume on this.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device

_BF16_KEY = "__bf16_keys__"


def _host_array(leaf) -> tuple[np.ndarray, bool]:
    """A leaf as a numpy array on the host, and whether it is bf16 (then
    as its uint16 bits). A tensor on the card is copied to the host here,
    once."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view(np.uint16), True
    return a, False


def _flatten(tree, prefix: str, out: dict, bf16: list) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out, bf16)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}#{i}/", out, bf16)
    else:
        key = prefix[:-1]
        out[key], is_bf16 = _host_array(tree)
        if is_bf16:
            bf16.append(key)


def save_pytree(path: str, tree) -> str:
    """Persist a tree of tensors or arrays to `path` (npz), atomically.

    Leaves on the card are copied to the host; the tree is flattened to
    '/'-joined keys and written through a same-directory temp file and
    `os.replace`, so the destination is either the complete new snapshot
    or untouched. bfloat16 leaves are stored as uint16 views plus a key
    manifest. A ``.npz`` suffix is appended if missing (as `np.savez`
    does); returns the path written.
    """
    flat: dict = {}
    bf16: list = []
    _flatten(tree, "", flat, bf16)
    flat[_BF16_KEY] = np.asarray(bf16)
    if not path.endswith(".npz"):
        path += ".npz"
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    # np.savez straight into the final path truncates before writing, so
    # a crash mid-write would tear the PREVIOUS snapshot; passing the open
    # file keeps np.savez from appending its own suffix to the temp name
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _insert(root: dict, parts: list[str], value) -> None:
    head = parts[0]
    if len(parts) == 1:
        root[head] = value
        return
    root.setdefault(head, {})
    _insert(root[head], parts[1:], value)


def _listify(node):
    """Convert dicts whose keys are exactly '#0'..'#n-1' into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    keys = list(node.keys())
    if keys and all(k.startswith("#") and k[1:].isdigit() for k in keys):
        idx = sorted(int(k[1:]) for k in keys)
        if idx == list(range(len(idx))):
            return [node[f"#{i}"] for i in idx]
    return node


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """A CPU bf16 tensor from an array of its uint16 (or int16) bits."""
    return torch.from_numpy(np.asarray(bits, order="C").view(np.int16)
                            ).view(torch.bfloat16)


def load_pytree(path: str, *, device: str | torch.device = DEFAULT_DEVICE,
                as_torch: bool = True):
    """Load a `save_pytree` snapshot (of either package) into a tree.

    Inverts the flattening ('/'-joined keys -> nested dicts, '#i'
    components -> lists). With `as_torch` every numeric leaf becomes a
    tensor on `device` (default "cuda", raising without a GPU unless
    "cpu"), bf16 leaves restored from their bits; text leaves (a snapshot's
    format tag) stay numpy. With ``as_torch=False`` the leaves stay numpy
    on the host and bf16 leaves come back as their uint16 bits; the root
    then carries the manifest of those keys under ``__bf16_keys__`` when
    there are any (host consumers such as `checkpoint.run_state`).
    """
    dev = resolve_device(device) if as_torch else None
    with np.load(path) as z:
        bf16 = (set(z[_BF16_KEY].tolist()) if _BF16_KEY in z.files
                else set())
        root: dict = {}
        for key in z.files:
            if key == _BF16_KEY:
                continue
            val = z[key]
            if as_torch and val.dtype.kind not in "US":
                val = (bf16_tensor(val) if key in bf16
                       else torch.from_numpy(val)).to(dev)
            _insert(root, key.split("/"), val)
    if bf16 and not as_torch:
        root[_BF16_KEY] = np.asarray(sorted(bf16))
    return _listify(root)
