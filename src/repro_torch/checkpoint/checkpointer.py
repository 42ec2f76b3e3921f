"""Async checkpointing with atomic commits, the port of the JAX package's
`checkpoint/checkpointer.py`, writing the same layout:

  * `save` snapshots every leaf to host memory synchronously (a copy, since
    the train step then updates the tensors in place), and writes on a
    background thread: one `.npy` per leaf and a `manifest.json` ({"step",
    "leaves": {key: {"file", "shape", "dtype"}}, "written_at"}) into
    `.tmp-N`, committed by an atomic rename to `step_%010d`, so a crash
    mid-write never leaves a partial checkpoint;
  * bf16 leaves are stored as their 16-bit patterns (`uint16`), with dtype
    "bfloat16" in the manifest, as the reference stores them;
  * `restore(like)` copies each leaf into the tensors of `like` in place,
    so a restore on the card never holds two states there;
  * the newest `keep_n` checkpoints are kept, older ones removed.

A leaf's key is its path, dict keys and list indices joined by "/"
("params/layers/0/attn/wq").

Sharded state (`shardings=`, a `sharding/rules.py::Shardings` over the
state's stacked view that states each rank's block of every leaf:
`state_shardings` of the train state, which follows what the train step
holds and updates on any mesh: the "model" blocks, FSDP's and the experts'
blocks over the data axes, ZeRO-1's blocks of the optimizer state on a
(dp, tp) mesh, Adafactor's statistics of each): every rank of the process
group calls `save` with its blocks; each leaf is gathered whole onto rank
0 (each distinct block sent once, by its first holder) and only rank 0
writes, in the same layout, so a checkpoint does not record the topology
that wrote it. A rank whose tensor is not the shape of its block raises
before anything is sent. `restore(like, shardings=...)` reshards to any
mesh (the same one, another shape after losing ranks, or one process):
each rank reads every leaf memory-mapped and copies only its block into
`like`, which holds the rank's blocks (empty tensors where another rank
owns the leaf), so no rank holds the whole state on top of its own. The
ranks meet at a barrier once rank 0's write has committed (at the next
`wait`, `save` or `restore`, or before a blocking `save` returns).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.tree import flatten


def _flatten(tree) -> Dict[str, Any]:
    return {"/".join(str(k) for k in path): leaf for path, leaf in flatten(tree)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _logical(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).replace("torch.", "")


def _gather(state, shardings) -> Optional[Dict[str, Any]]:
    """Every leaf of a sharded state, whole, on rank 0 (host copies); None
    on the other ranks."""
    rank, n = dist.get_rank(), dist.get_world_size()
    blocks = [shardings.index(state, q) for q in range(n)]
    _check_blocks(state, blocks[rank])
    out = {} if rank == 0 else None
    for j, (path, t) in enumerate(flatten(state)):
        whole = torch.empty(shardings.full_shape(path), dtype=t.dtype) if rank == 0 else None
        sent = []
        for q in range(n):
            b = blocks[q][j]
            if b is None or b in sent:
                continue
            sent.append(b)
            if q == rank == 0:
                whole[b] = t.detach().cpu()
            elif rank == q:
                D.send(t.detach(), 0)
            elif rank == 0:
                whole[b] = D.recv(t.new_empty(whole[b].shape), q).cpu()
        if rank == 0:
            out["/".join(str(k) for k in path)] = (_to_host(whole), _logical(t))
    return out


def _check_blocks(tree, index) -> None:
    """Raise where a leaf of `tree` is not the shape of its block (`index`,
    None: another rank owns it, and the rank holds an empty tensor)."""
    for (path, t), b in zip(flatten(tree), index):
        want = (0,) if b is None else tuple(s.stop - s.start for s in b)
        if tuple(t.shape) != want and not (b is None and t.numel() == 0):
            raise ValueError(f"{'/'.join(map(str, path))}: the rank holds {tuple(t.shape)}, "
                             f"its block under the shardings is {want}")


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False   # a sharded save's ranks have yet to meet
        self.stats = {"saves": 0, "restores": 0, "gcs": 0}

    # -- save -------------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = False,
             shardings=None) -> None:
        """Snapshot to host memory synchronously, write asynchronously (or
        before returning, with `blocking`). With `shardings`, every rank
        calls this with its blocks of `state`, and rank 0 writes."""
        self.wait()
        if shardings is None:
            flat = {k: (_to_host(v), _logical(v)) for k, v in _flatten(state).items()}
        else:
            flat = _gather(state, shardings)
            self._barrier = True
            if flat is None:
                if blocking:
                    self.wait()
                return

        def _write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}, "written_at": time.time()}
            for key, (arr, logical) in flat.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                           "dtype": logical}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, final)
            self.stats["saves"] += 1
            self._gc()

        def _write_and_keep_error():
            try:
                _write()
            except BaseException as e:   # re-raised by wait(), in the caller's thread
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write_and_keep_error, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; raise what it raised. After a sharded save, meet
        the other ranks once rank 0's write has committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir) if d.startswith("step_")]
        return max(steps) if steps else None

    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None, shardings=None) -> Any:
        """Copy checkpoint `step` (the latest by default) into the tensors
        of `like`, in place, casting to their dtypes; returns `like`. With
        `shardings`, `like` holds this rank's blocks, and each takes its
        block of the whole leaf."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        items = _flatten(like).items()
        blocks = [()] * len(items)
        if shardings is not None:
            blocks = shardings.index(like, dist.get_rank())
            _check_blocks(like, blocks)
        for (key, t), b in zip(items, blocks):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
            if b is None:   # another rank owns this leaf
                continue
            arr = np.load(os.path.join(cdir, meta["file"]), mmap_mode="r")
            if meta["dtype"] == "bfloat16":
                arr = arr.view(np.int16)
            src = torch.from_numpy(np.array(arr[b]))   # a copy, read from the map
            if meta["dtype"] == "bfloat16":
                src = src.view(torch.bfloat16)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)}, "
                                 f"want {tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
        self.stats["restores"] += 1
        return like

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)
            self.stats["gcs"] += 1
