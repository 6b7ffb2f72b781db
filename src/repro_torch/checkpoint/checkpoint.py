"""Checkpoints: per-leaf .npy files and a JSON manifest, atomic commit,
keep-last-k, restore onto another device (counterpart of
``repro.checkpoint.checkpoint``; the on-disk layout is the reference's).

Layout:
  <dir>/step_000000042.tmp/...   (write)
  <dir>/step_000000042/          (atomic rename = commit)
      MANIFEST.json              {step, leaves: {path: {file, shape,
                                  dtype}}, meta}
      <flattened.key.path>.npy

A tree is nested dicts (keys sorted), lists, tuples and NamedTuples (``[i]``
per position, NamedTuple fields by index) of tensors, numpy arrays or
scalars. An ``nn.Module`` in the tree stands for its parameters by name
(``LM``'s names are the reference's keys, one entry per layer). Leaves
are copied to the host and stored as numpy arrays. numpy has no bfloat16,
so a bfloat16 tensor is stored as its uint16 bits with ``"dtype":
"bfloat16"`` in the manifest (the reference's bfloat16 leaves carry the
same tag over 2-byte records) and restored bit for bit; a dtype numpy
lacks otherwise raises, and nothing is widened.

Restore loads the leaves on the host and places them with ``device=``
(one device, or a tree of devices shaped as the template): the
reference's ``shardings=``, so a run saved on one device list resumes on
another. A dict-of-arrays checkpoint written by either package loads in
the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, nn.Module):
            node = dict(node.named_parameters())
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}.{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                rec(f"{prefix}[{i}]", v)
        else:
            flat[prefix] = node
    rec("", tree)
    return flat


def _unflatten_into(template, build: Callable[[str, Any], Any]):
    """``template``'s structure with each leaf replaced by ``build(key,
    leaf)``. A module's parameters become the built tensors (new
    ``nn.Parameter``s that keep ``requires_grad``, on whatever device they
    were built: a template module on the meta device holds no memory) and
    the module itself is returned."""
    def rec(prefix, node):
        if isinstance(node, nn.Module):
            for name, p in list(node.named_parameters()):
                owner, _, attr = name.rpartition(".")
                setattr(node.get_submodule(owner), attr, nn.Parameter(
                    build(f"{prefix}.{name}" if prefix else name, p),
                    requires_grad=p.requires_grad))
            return node
        if isinstance(node, dict):
            return {k: rec(f"{prefix}.{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            seq = [rec(f"{prefix}[{i}]", v) for i, v in enumerate(node)]
            return type(node)(seq) if not hasattr(node, "_fields") else \
                type(node)(*seq)
        return build(prefix, node)
    return rec("", template)


def _to_numpy(v) -> tuple:
    """(host array, manifest dtype) of a leaf."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = v.numpy()             # raises for a dtype numpy lacks
        return arr, str(arr.dtype)
    arr = np.asarray(v)
    return arr, str(arr.dtype)


def save_pytree(tree, directory: str, step: int,
                meta: Optional[dict] = None, keep: int = 3) -> str:
    """Write a checkpoint atomically; prune to the newest ``keep``."""
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for key, v in _flatten(tree).items():
        arr, dtype = _to_numpy(v)
        fn = re.sub(r"[^A-Za-z0-9_.\[\]-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int):
    steps = sorted(
        (d for d in os.listdir(directory)
         if re.fullmatch(r"step_\d+", d)))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step (a ``step_*`` directory with a manifest;
    ``.tmp`` directories are not committed), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if re.fullmatch(r"step_\d+", d)
             and os.path.exists(os.path.join(directory, d,
                                             "MANIFEST.json"))]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")   # keeps a 0-d array 0-d
    if dtype == "bfloat16":         # uint16 bits, or the reference's V2
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_pytree(template, directory: str, step: int, device=None):
    """Restore into ``template``'s structure; returns (tree, meta).

    ``device``: one device for every leaf, a tree of devices shaped as
    ``template`` (a leaf it leaves out, or None, keeps the default), or
    None: each leaf goes to its template tensor's device, and a leaf whose
    template is no tensor, or a tensor on the meta device (a template that
    holds no memory), to ``resolve_device()``. A stored dtype that differs
    from its template tensor's raises."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if device is None or isinstance(device, (str, torch.device)):
        flat_dev = {}
        one = device
    else:
        flat_dev = _flatten(device)
        one = None

    def build(key, tmpl):
        info = manifest["leaves"][key]
        t = _from_numpy(np.load(os.path.join(path, info["file"])),
                        info["dtype"])
        if isinstance(tmpl, torch.Tensor) and tmpl.dtype != t.dtype:
            raise TypeError(f"{key}: stored {info['dtype']}, the template "
                            f"holds {tmpl.dtype}")
        dev = flat_dev.get(key) or one
        if dev is None:
            dev = (tmpl.device if isinstance(tmpl, torch.Tensor)
                   and tmpl.device.type != "meta" else None)
        return t.to(resolve_device(dev))
    return _unflatten_into(template, build), manifest["meta"]


class CheckpointManager:
    """Train-loop helper: periodic save, auto-resume, keep-k."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.dir = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree, meta: Optional[dict] = None,
                   force: bool = False):
        if force or (step > 0 and step % self.every == 0):
            return save_pytree(tree, self.dir, step, meta, self.keep)
        return None

    def restore_latest(self, template, device=None):
        step = latest_step(self.dir)
        if step is None:
            return None, None, None
        tree, meta = load_pytree(template, self.dir, step, device)
        return step, tree, meta
