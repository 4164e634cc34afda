"""Fault-tolerant checkpoints in the JAX package's on-disk format.

Port of ``repro/training/checkpoint.py``; a checkpoint written by either
package restores in the port:

* step directories ``ckpt_<step>/`` written atomically (a temporary directory
  renamed into place), so a crash mid-save never corrupts the latest one;
* one ``.npy`` a leaf, named by a hash of its flat key (dict keys joined by
  ``"::"``, ``#i`` for sequence indices), and a ``manifest.json`` with each
  leaf's shape, dtype and crc32; a file whose crc differs is refused;
* an asynchronous save: one device-to-host copy of the tree, then the write in
  a thread, one save in flight at a time;
* ``keep_last`` retention;
* under a grid (``utils.sharding``), ``save(..., shardings=)`` gathers each
  leaf's blocks (counted ``all_gather`` calls on every rank), rank 0 writes
  the files and every rank waits at a barrier until they are published, so a
  checkpoint written on a grid is the same files as one written on one
  device; ``restore(..., shardings=)`` loads the whole leaves and returns
  this rank's block of each, so a job may restart on another layout
  (elastic: another grid, or one device).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import comm

__all__ = ["CheckpointManager", "SEP"]

SEP = "::"


def _flatten(tree, prefix=()):
    """``{flat key: leaf}`` of nested dicts, lists and tuples, JAX's key order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (f"#{i}",)))
        return out
    return {SEP.join(prefix): tree}


def _unflatten_into(template, flat, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, prefix + (f"#{i}",))
                              for i, v in enumerate(template))
    return flat[SEP.join(prefix)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 as its 2-byte words (``|V2``), the layout
    JAX's ``ml_dtypes`` arrays are saved in, so neither side needs the other's
    dtype package."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_torch(a: np.ndarray, dtype_name: str, like: torch.Tensor) -> torch.Tensor:
    if dtype_name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.int16).copy()
        t = torch.from_numpy(words).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ----
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             shardings: Any = None) -> None:
        """Copy ``tree`` to the host, then write it (in a thread unless
        ``blocking`` or the manager is synchronous).

        With ``shardings`` (a ``Placement`` a leaf, mirroring ``tree``, whose
        leaves are this rank's blocks) every rank must call it: the leaves are
        gathered, rank 0 writes them synchronously, and every rank returns
        once the checkpoint is published.
        """
        self.wait()                                      # one save in flight at most
        if shardings is not None:
            from repro_torch.utils.sharding import gather
            flat_p = _flatten(shardings)
            tree = {k: gather(v.detach(), flat_p[k]) for k, v in _flatten(tree).items()}
        host = {k: (_to_numpy(v.detach().to("cpu", copy=True)), str(v.dtype).split(".")[-1])
                for k, v in _flatten(tree).items()}
        if shardings is not None:
            if comm.axis_index() == 0:
                self._write(step, host)
            comm.barrier()
            return
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=self._write, args=(step, host),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, flat) -> None:
        tmp = os.path.join(self.dir, f".tmp_ckpt_{step}")
        final = os.path.join(self.dir, f"ckpt_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": {}}
        for key, (arr, dtype_name) in flat.items():
            fname = f"{hashlib.sha1(key.encode()).hexdigest()[:16]}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": "bfloat16" if dtype_name == "bfloat16" else str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                            # the atomic publish
        self._gc()

    def wait(self) -> None:
        """Block until the save in flight, if any, is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{s}"), ignore_errors=True)

    # ---- restore ----
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, *, shardings=None) -> Any:
        """Load step ``step``, verify every crc, and return ``template``'s
        structure with each leaf on its template's device and dtype.

        With ``shardings`` (a ``utils.sharding.Placement`` a leaf, mirroring
        ``template``) each leaf is this rank's block of the saved array, cut
        after the load; the template's leaves then give only device and dtype
        (they may be blocks of another layout, or whole).

        Raises:
            IOError: a file's crc32 differs from the manifest's.
            KeyError: the checkpoint lacks a leaf of ``template``.
            ValueError: a saved shape differs from its placement's.
        """
        d = os.path.join(self.dir, f"ckpt_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat, dtypes = {}, {}
        for key, meta in manifest["arrays"].items():
            arr = np.load(os.path.join(d, meta["file"]))
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption detected for {key!r} "
                              f"(crc {crc:#x} != {meta['crc32']:#x})")
            flat[key], dtypes[key] = arr, meta["dtype"]
        tpl = _flatten(template)
        missing = sorted(set(tpl) - set(flat))
        if missing:
            raise KeyError(f"checkpoint {d} lacks {missing[:5]}")
        if shardings is None:
            return _unflatten_into(template, {k: _to_torch(flat[k], dtypes[k], t)
                                              for k, t in tpl.items()})
        from repro_torch.utils.sharding import block_slices
        places = _flatten(shardings)
        out = {}
        for k, t in tpl.items():
            pl = places[k]
            if tuple(flat[k].shape) != tuple(pl.shape):
                raise ValueError(f"checkpoint {d}: {k!r} is {tuple(flat[k].shape)}, its "
                                 f"placement {tuple(pl.shape)}")
            block = np.array(flat[k][block_slices(pl)])        # a copy, 0-d kept 0-d
            out[k] = _to_torch(block, dtypes[k], t)
        return _unflatten_into(template, out)
