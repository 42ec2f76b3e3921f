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
("params/layers/0/attn/wq"). The reference's resharding restore
(`shardings=`) waits for the multi-device item (ROADMAP.md, Queue 1).
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

from repro_torch.tree import flatten


def _flatten(tree) -> Dict[str, Any]:
    return {"/".join(str(k) for k in path): leaf for path, leaf in flatten(tree)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats = {"saves": 0, "restores": 0, "gcs": 0}

    # -- save -------------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write asynchronously (or
        before returning, with `blocking`)."""
        flat = {k: (_to_host(v), "bfloat16" if v.dtype == torch.bfloat16
                    else str(v.dtype).replace("torch.", ""))
                for k, v in _flatten(state).items()}

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

        self.wait()
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_and_keep_error, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir) if d.startswith("step_")]
        return max(steps) if steps else None

    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Copy checkpoint `step` (the latest by default) into the tensors
        of `like`, in place, casting to their dtypes; returns `like`."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        for key, t in _flatten(like).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
            arr = np.load(os.path.join(cdir, meta["file"]))
            src = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
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
