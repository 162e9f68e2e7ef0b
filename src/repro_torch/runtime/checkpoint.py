"""Checkpoint/restart — counterpart of ``repro/runtime/checkpoint.py``,
writing the JAX package's format, so a checkpoint either package writes
is one the other restores.

* **Atomic**: write to a temp dir, fsync, rename. A killed writer never
  corrupts the latest checkpoint — ``list_checkpoints`` skips leftover
  ``.tmp_*`` dirs and any ``step_*`` dir whose manifest is missing or
  truncated, so a crash can never be selected as latest either.
* **Self-describing**: ``arrays.npz`` holds the leaves as ``arr_i`` and
  ``manifest.json`` the step, each leaf's path, shape, dtype and sha256
  digest (``format_version`` 1). Restore validates the payload against
  the manifest and tensor targets against the saved shapes, with the
  leaf named in the error.
* **Paths** are named as JAX's ``tree_flatten_with_path`` names them:
  dict keys in sorted order, list and tuple indices, a named tuple's
  fields as ``.field`` (``AdamState``'s ``.step``, ``.m``, ``.v``);
  ``None`` is no leaf. A full-batch ``(params, opt_state)`` gives
  ``0/layers/0/w`` and ``1/.m/layers/0/w``.
* **Host counts**: a Python ``int`` leaf (the optimizer's step count,
  which the port keeps on the host) is saved as int32, as the JAX package
  holds it, and restored as a host ``int`` whichever package wrote it.
* **keep_n** garbage collection bounds disk usage (and sweeps dead
  ``.tmp_*`` dirs left by killed writers).
* **Injectable kills**: ``save_checkpoint(..., injector=)`` fires the
  ``checkpoint_kill`` site between payload write and rename, leaving the
  tmp dir behind as a real kill would.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch

_MANIFEST_KEYS = ("step", "paths", "shapes", "dtypes")


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for name in tree._fields
                for pl in _flatten_with_paths(getattr(tree, name),
                                              prefix + ("." + name,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (flattening order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep_n: int = 3,
                    injector=None) -> str:
    """Atomically persist ``state`` (a tree of tensors, arrays and host
    counts) at ``step``; returns the checkpoint's dir.

    ``injector`` (a ``runtime.resilience.FaultInjector``) may fire its
    ``checkpoint_kill`` site after the payload is written but before the
    rename: the ``InjectedFault`` propagates without cleanup, as a killed
    process cleans nothing, and the orphaned ``.tmp_*`` dir exercises the
    readers' skip logic."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten_with_paths(state)
    arrays = {f"arr_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    manifest = {
        "step": int(step),
        "paths": [p for p, _ in flat],
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "digests": [_digest(a) for a in arrays.values()],
        "format_version": 1,
    }
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if injector is not None:
            injector.maybe_kill("checkpoint_kill", step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException as e:
        # an InjectedFault models SIGKILL: the dead writer cleans nothing
        if type(e).__name__ != "InjectedFault":
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep_n)
    return final


def _gc(ckpt_dir: str, keep_n: int):
    steps = sorted(list_checkpoints(ckpt_dir))
    for s in steps[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)
    # dead writers' leftovers are invisible to list_checkpoints already,
    # but unbounded tmp litter would defeat keep_n's disk bound
    for name in os.listdir(ckpt_dir):
        if name.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _valid_manifest(path: str) -> Optional[dict]:
    """A checkpoint dir's manifest, or None if the checkpoint is unusable
    (missing or truncated manifest, missing payload, inconsistent
    metadata): such dirs are skipped, never selected."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isfile(mpath) or not os.path.isfile(
            os.path.join(path, "arrays.npz")):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    if not all(k in manifest for k in _MANIFEST_KEYS):
        return None
    n = len(manifest["paths"])
    if len(manifest["shapes"]) != n or len(manifest["dtypes"]) != n:
        return None
    return manifest


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """Steps with a valid checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[5:])
        except ValueError:
            continue
        if _valid_manifest(os.path.join(ckpt_dir, name)) is not None:
            out.append(step)
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _load_leaves(path: str, manifest: dict) -> list:
    try:
        data = np.load(os.path.join(path, "arrays.npz"))
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise ValueError(
            f"checkpoint {path} payload is corrupt (unreadable archive): "
            f"{e}") from e
    digests = manifest.get("digests")  # absent on older saves
    leaves = []
    for i, leaf in enumerate(manifest["paths"]):
        key = f"arr_{i}"
        if key not in data:
            raise ValueError(
                f"checkpoint {path} payload is truncated: missing {key} "
                f"(leaf {leaf!r})")
        try:
            arr = data[key]
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise ValueError(
                f"checkpoint {path} leaf {leaf!r} is corrupt on disk "
                f"(payload fails to decode: {e})") from e
        want_shape = tuple(manifest["shapes"][i])
        want_dtype = manifest["dtypes"][i]
        if tuple(arr.shape) != want_shape or str(arr.dtype) != want_dtype:
            raise ValueError(
                f"checkpoint {path} leaf {leaf!r} does not "
                f"match its manifest: saved {arr.shape}/{arr.dtype}, "
                f"manifest says {want_shape}/{want_dtype}")
        if digests is not None:
            got = _digest(arr)
            if got != digests[i]:
                raise ValueError(
                    f"checkpoint {path} leaf {leaf!r} is corrupt on disk: "
                    f"sha256 {got[:16]}… does not match the manifest's "
                    f"{digests[i][:16]}… (payload bit-rot)")
        leaves.append(arr)
    return leaves


def _place(path: str, target, arr: np.ndarray):
    """``arr`` as the target leaf holds it: a tensor on the target's
    device and dtype, a host ``int`` for an int, else the array."""
    if isinstance(target, torch.Tensor):
        if tuple(target.shape) != tuple(arr.shape):
            raise ValueError(
                f"checkpoint leaf {path!r} shape {tuple(arr.shape)} does not "
                f"fit target tensor of shape {tuple(target.shape)} — was the "
                f"model reconfigured since the save?")
        return torch.from_numpy(np.array(arr)).to(device=target.device,
                                                  dtype=target.dtype)
    if isinstance(target, int) and not isinstance(target, bool):
        if arr.shape != ():
            raise ValueError(f"checkpoint leaf {path!r} shape {arr.shape} "
                             f"does not fit a host count")
        return int(arr)
    return arr


def restore_checkpoint(ckpt_dir: str, target: Any, step: Optional[int] = None):
    """Restore into the structure of ``target``; returns (state, step).

    Returns ``target`` unchanged (and step ``None``) if no checkpoint
    exists. Tensors come back on the target leaf's device and in its
    dtype. The payload is validated against the manifest (shape, dtype,
    digest) and tensor targets against the saved shapes, so a corrupt or
    mismatched checkpoint fails here with a named leaf."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return target, None
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    manifest = _valid_manifest(path)
    if manifest is None:
        raise ValueError(
            f"checkpoint at {path} is missing or corrupt "
            "(truncated manifest or absent payload)")
    leaves = _load_leaves(path, manifest)
    flat = _flatten_with_paths(target)
    t_paths = [p for p, _ in flat]
    if t_paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch:\n saved: %s\n target: %s"
            % (manifest["paths"][:5], t_paths[:5]))
    placed = [_place(p, tgt, arr) for (p, tgt), arr in zip(flat, leaves)]
    return _unflatten(target, placed), step
