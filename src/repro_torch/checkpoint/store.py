"""Checkpoints: npz payloads + JSON manifest, elastic restore — twin of
``repro.checkpoint.store``, in its file format, so each package reads the
other's checkpoints.

* ``save``: atomically writes (``step_%08d.tmp`` renamed to ``step_%08d``)
  a manifest (``step``, ``data_index``, per group every leaf's shape and
  dtype, and the logical specs) and one npz per top-level group, leaves
  keyed by their ``/``-joined path.  A state is nested mappings of numpy
  arrays or tensors (copied to the host); a model's parameters and AdamW
  state go in the reference's stacked layout
  (``convert.model_params_to_numpy``, ``convert.adamw_state_to_numpy``).
* ``restore``: rebuilds the tree as tensors on ``device``.  With a mesh
  and specs, every spec is checked against the *current* mesh first (the
  elastic restart: specs are logical, and a spec written on 8 data ways
  re-derived for 2 is another spec of the same arrays).
* ``latest_step`` / retention: keep-last-k garbage collection.

The manifest stores the next data index; resuming replays exactly the
batches a run without the failure would have seen.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import LogicalMesh, check_spec

Pytree = Any

MANIFEST = "manifest.json"


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Pytree:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _spec_to_json(spec) -> list:
    return [list(d) if isinstance(d, (tuple, list)) else d for d in spec]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _device(device) -> torch.device:
    """The card when None (raises without one); otherwise the device as
    given, unchecked, so that an explicit ``"cuda"`` fails only where a
    tensor goes there.  ``core.offload.resolve_device`` raises for that
    one too, hence a function of its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("restore: no CUDA device; pass device='cpu' "
                               "to restore on the host")
        return torch.device("cuda")
    return torch.device(device)


def save(
    directory: str,
    step: int,
    state: Dict[str, Pytree],          # e.g. {"params": ..., "opt": ...}
    specs: Optional[Dict[str, Pytree]] = None,
    data_index: int = 0,
    keep: int = 3,
) -> str:
    """Write checkpoint for `step`; returns the checkpoint path."""
    ckpt = os.path.join(directory, f"step_{step:08d}")
    tmp = ckpt + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest: Dict[str, Any] = {
        "step": step, "data_index": data_index, "groups": {}, "specs": {},
    }
    for group, tree in state.items():
        arrays = {k: _host(v) for k, v in _flatten(tree).items()}
        np.savez(os.path.join(tmp, f"{group}.npz"), **arrays)
        manifest["groups"][group] = {
            k: {"shape": list(a.shape), "dtype": str(a.dtype)}
            for k, a in arrays.items()
        }
        if specs and group in specs:
            manifest["specs"][group] = {
                k: _spec_to_json(s) for k, s in _flatten(specs[group]).items()
            }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)
    _gc(directory, keep)
    return ckpt


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(
    directory: str,
    mesh: Optional[LogicalMesh] = None,
    specs: Optional[Dict[str, Pytree]] = None,
    step: Optional[int] = None,
    *,
    device=None,
) -> Tuple[int, int, Dict[str, Pytree]]:
    """-> (step, data_index, state), every leaf a tensor on ``device``
    (the card when None; raises without one).  With ``mesh`` and
    ``specs``, each leaf's spec (replicated when absent) must lay it out
    on ``mesh``, or this raises before anything is placed."""
    dev = _device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, MANIFEST)) as f:
        manifest = json.load(f)
    state: Dict[str, Pytree] = {}
    for group in manifest["groups"]:
        with np.load(os.path.join(ckpt, f"{group}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        if mesh is not None and specs is not None and group in specs:
            sflat = _flatten(specs[group])
            for k, arr in flat.items():
                check_spec(sflat.get(k, ()), arr.shape, mesh,
                           f"{group}/{k}")
        state[group] = _unflatten(
            {k: torch.from_numpy(arr).to(dev) for k, arr in flat.items()})
    return manifest["step"], manifest["data_index"], state


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d))
