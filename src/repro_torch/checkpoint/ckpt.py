"""Checkpointing with atomic commits (torch; a port of
``repro/checkpoint/ckpt.py``).

Layout:  <dir>/step_<N>/
            manifest.json        (step, meta, each leaf's shape and dtype,
                                  the "complete" flag)
            <flat-key>.npy       (one file per leaf, gathered to the host)

JAX's contract, kept whole:
  * atomic: written to step_<N>.tmp, fsync'd, renamed — a crash mid-save
    never corrupts the latest complete checkpoint;
  * resumable: ``latest_step`` only returns directories whose manifest
    carries the "complete" flag;
  * bounded: ``keep`` retains the most recent checkpoints only.

A tree is nested dicts, lists, tuples and NamedTuples of tensors, with
``nn.Module`` leaves standing for their state dicts, so the train state
``(model, AdamWState)`` has keys ``0__<state-dict name>`` and
``1__mu__<name>``, ``1__step`` ...; None is an empty subtree (no master
kept).  bf16 leaves are stored as their raw 16 bits (a uint16 array, as
JAX stores them; numpy has no bfloat16 and the port does not import
``ml_dtypes``).  ``restore`` writes each loaded leaf into the target
tree's tensor in place, on that tensor's device (JAX returns new arrays
and reshards them onto a mesh; the port's state lives on one device).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

_SEP = "__"


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str,
                                                           torch.Tensor]]:
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield key(name), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, key(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), key(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, key(i))
    else:
        raise TypeError(f"checkpoint leaf {prefix!r}: expected a tensor, "
                        f"got {type(tree).__name__}")


def save(ckpt_dir: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for key, leaf in _leaves(tree):
        t = leaf.detach().cpu()
        logical = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": logical}
    manifest["complete"] = True
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        mpath = os.path.join(ckpt_dir, name, "manifest.json")
        try:
            with open(mpath) as f:
                if json.load(f).get("complete"):
                    out.append(int(m.group(1)))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Load checkpoint ``step`` (the latest complete one by default) into
    ``target_tree``'s tensors, in place; returns (target_tree, step,
    meta).  Every leaf of the target must be in the checkpoint with its
    shape and dtype."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for key, ref in _leaves(target_tree):
        arr = np.load(os.path.join(d, key + ".npy"))
        logical = manifest["leaves"].get(key, {}).get("dtype",
                                                      str(arr.dtype))
        if logical == "bfloat16":                 # the raw 16 bits
            src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(arr)
        if src.dtype != ref.dtype or tuple(src.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {key!r}: {src.dtype} "
                             f"{tuple(src.shape)} does not fit the target's "
                             f"{ref.dtype} {tuple(ref.shape)}")
        ref.copy_(src)
    return target_tree, step, manifest.get("meta", {})
