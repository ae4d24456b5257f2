"""Atomic checkpoints of a tree of tensors, the port of the reference's
``train/checkpoint.py``, with its on-disk layout: one directory per step,

    step_00000120.tmp/          (written, then renamed)
      manifest.json             step, leaf count, tree, shapes, dtypes,
                                the caller's ``extra``
      arr_00000.npy ...         one .npy per leaf, in the tree's leaf order
    step_00000120/

* atomic publish: a crash while writing never corrupts the latest
  checkpoint (tmp directory, then a rename);
* async save: the copy to the host is synchronous and always a copy,
  into buffers that nothing else owns (on the CPU too, where ``.cpu()``
  would return the leaf itself and a donated step would overwrite it
  under the writer); the file writes run on a thread, whose handle
  :func:`save` returns;
* retention: the last ``keep_last`` checkpoints are kept.

A tree of DTensors (a program over a device mesh) is saved in the same
layout: every rank calls :func:`save`, each leaf is gathered whole (a
collective), and only global rank 0 writes; :func:`restore` reads the
whole leaves on every rank and copies each rank's own shard, cut on that
rank, into the target's local shards (no collective). :func:`restore`
writes into the target's own tensors, so that a restart keeps the
tensors a CUDA graph of the step holds.

Leaves are stored as whole host arrays; bf16, which ``.npy`` cannot hold,
as its raw bits in uint16 (the manifest keeps ``"bfloat16"``), read back
through a torch uint16 view. The leaf order is ``train.tree``'s (JAX's),
so a tree's manifest lists the shapes and dtypes the reference's lists.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train import tree as tr

MANIFEST = "manifest.json"


def _is_dtensor(x) -> bool:
    return getattr(x, "device_mesh", None) is not None


def _host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf (a DTensor gathered whole) as a host array of its own and
    its dtype's name."""
    if _is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.uint16).numpy(), "bfloat16"
    a = x.numpy()
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         async_write: bool = True,
         keep_last: int = 3) -> threading.Thread | None:
    """Copy ``tree`` to the host and write checkpoint ``step``; with
    ``async_write`` the writes run on the returned (started) thread. For
    a tree with DTensor leaves only global rank 0 writes (None on the
    others)."""
    leaves, treedef = tr.flatten(tree)
    if any(_is_dtensor(x) for x in leaves):
        import torch.distributed as dist

        if dist.get_rank() != 0:      # it joins the gathers, writes nothing
            for x in leaves:
                if _is_dtensor(x):
                    x.full_tensor()
            return None
    host = [_host(x) for x in leaves]
    os.makedirs(ckpt_dir, exist_ok=True)

    def write():
        name = f"step_{step:08d}"
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        final = os.path.join(ckpt_dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "treedef": repr(treedef),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [dt for _, dt in host],
            "extra": extra or {},
        }
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), a)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _gc(ckpt_dir, keep_last)

    if async_write:
        th = threading.Thread(target=write, daemon=True)
        th.start()
        return th
    write()
    return None


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree) -> tuple[Any, dict]:
    """Checkpoint ``step`` copied into the leaves of ``tree`` (tensors, or
    DTensors, each of which takes its shard of the whole leaf), in place:
    a CUDA graph that holds their addresses, or a donated step, goes on
    with the same tensors. A leaf whose shape or dtype is not the
    checkpoint's is refused before anything is written. Returns ``(tree,
    extra)``."""
    name = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(name, MANIFEST)) as f:
        manifest = json.load(f)
    leaves = tr.leaves(tree)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"restore target has {len(leaves)}")
    for i, ref in enumerate(leaves):
        shape = tuple(manifest["shapes"][i])
        dtype = str(ref.dtype).removeprefix("torch.")
        if shape != tuple(ref.shape) or manifest["dtypes"][i] != dtype:
            raise ValueError(f"leaf {i}: checkpoint {shape} "
                             f"{manifest['dtypes'][i]} != target "
                             f"{tuple(ref.shape)} {dtype}")
    for i, ref in enumerate(leaves):
        t = torch.from_numpy(np.load(os.path.join(name, f"arr_{i:05d}.npy")))
        if manifest["dtypes"][i] == "bfloat16":
            t = t.view(torch.bfloat16)
        if _is_dtensor(ref):
            from repro_torch.nn.sharding import local_part, pspec_of

            # this rank's shard, cut from the whole leaf every rank read:
            # no collective, and only the shard goes up
            ref.to_local().copy_(local_part(t, ref.device_mesh,
                                            pspec_of(ref)))
        else:
            ref.copy_(t)
    return tree, manifest["extra"]
