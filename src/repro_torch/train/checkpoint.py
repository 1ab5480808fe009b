"""Step-atomic checkpointing with integrity digests, retention and resume.

Layout (the JAX package's):
         <dir>/step_000123/
             manifest.json     (tree structure, shapes, dtypes, digests, meta)
             arrays.npz        (flat path -> ndarray)
         <dir>/LATEST          (atomically updated pointer)

Writes go to a temp dir + os.replace for atomicity (a crashed writer never
corrupts LATEST); every array carries a crc32 digest verified on restore.
``CheckpointManager`` adds retention, auto-resume and an async (background
thread) save mode.

A float32 or integer tensor is stored as the JAX package stores the same
array: the same bytes, dtype and digest, so a tree of them saved by either
package restores in the other. The rest is stored without pickling and
without numpy knowing bfloat16:

* a bfloat16 tensor as its ``uint16`` view, ``"dtype": "bfloat16"`` in the
  manifest;
* a ``Packed8`` moment at ``<path>`` as two arrays, ``<path>/q`` (int8) and
  ``<path>/s`` (float32), with its shape under the manifest's ``"packed8"``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pruning import _flatten, _unflatten
from repro_torch.train.optimizer import Packed8


def _digest(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _host(x) -> np.ndarray:
    """A tensor (any device) as a numpy array that owns its bytes: bfloat16
    as its uint16 view."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def host_snapshot(tree: Any) -> Dict[str, Any]:
    """The flat host copy of a tree that a checkpoint holds: path -> numpy
    array, each array's manifest dtype, and each ``Packed8``'s shape.
    Nothing in it shares memory with the tree."""
    arrays, dtypes, packed = {}, {}, {}
    for k, v in _flatten(tree).items():
        parts = {k: v}
        if isinstance(v, Packed8):
            parts = {f"{k}/q": v.q, f"{k}/s": v.s}
            packed[k] = list(v.shape)
        for name, x in parts.items():
            arrays[name] = _host(x)
            bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            dtypes[name] = "bfloat16" if bf16 else str(arrays[name].dtype)
    return {"arrays": arrays, "dtypes": dtypes, "packed8": packed}


def save_checkpoint(path: str, step: int, tree: Any,
                    meta: Optional[Dict] = None) -> str:
    """Atomic write of one checkpoint. Returns the final directory."""
    return _write(path, step, host_snapshot(tree), meta)


def _write(path: str, step: int, snap: Dict[str, Any],
           meta: Optional[Dict]) -> str:
    flat = snap["arrays"]
    final = os.path.join(path, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "meta": meta or {},
            "arrays": {k: {"shape": list(v.shape), "dtype": snap["dtypes"][k],
                           "crc32": _digest(v)} for k, v in flat.items()},
        }
        if snap["packed8"]:
            manifest["packed8"] = snap["packed8"]
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(path, ".LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(path, ".LATEST.tmp"), os.path.join(path, "LATEST"))
    return final


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(path, name)):
        return None
    return int(name.split("_")[-1])


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def restore_checkpoint(path: str, step: Optional[int] = None,
                       verify: bool = True, device="cpu"):
    """Returns (tree of tensors on ``device``, step, meta). Raises on digest
    mismatch."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz"), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    if verify:
        for k, info in manifest["arrays"].items():
            if _digest(flat[k]) != info["crc32"]:
                raise IOError(f"checkpoint corruption: digest mismatch at {k}")
    dtypes = {k: info["dtype"] for k, info in manifest["arrays"].items()}
    out = {k: _tensor(a, dtypes.get(k, str(a.dtype)), device)
           for k, a in flat.items()}
    for k, shape in manifest.get("packed8", {}).items():
        out[k] = Packed8(out.pop(f"{k}/q"), out.pop(f"{k}/s"), shape)
    return _unflatten(out), manifest["step"], manifest.get("meta", {})


class CheckpointManager:
    """Retention + auto-resume + optional async save.

    ``save`` copies the tree to host memory before it returns, in async mode
    too, so the caller may update the tensors in place right after. An
    error of a background save is raised by the next ``wait`` (and so by the
    next ``save`` or ``restore_or_none``)."""

    def __init__(self, path: str, keep: int = 3, async_save: bool = False):
        self.path = path
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None):
        snap = host_snapshot(tree)                 # off the device, now
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_async, args=(step, snap, meta), daemon=True)
            self._thread.start()
        else:
            self._save_sync(step, snap, meta)

    def _save_sync(self, step, snap, meta):
        _write(self.path, step, snap, meta)
        self._gc()

    def _save_async(self, step, snap, meta):
        try:
            self._save_sync(step, snap, meta)
        except BaseException as e:                 # re-raised by wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        if not os.path.isdir(self.path):
            return
        steps = sorted(int(n.split("_")[-1]) for n in os.listdir(self.path)
                       if n.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_or_none(self, device="cpu"):
        """The newest checkpoint (after any save in flight has landed) on
        ``device``, or None when there is none or it is corrupt."""
        self.wait()
        try:
            return restore_checkpoint(self.path, device=device)
        except (FileNotFoundError, IOError):
            return None
