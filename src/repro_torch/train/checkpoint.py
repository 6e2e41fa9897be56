"""Checkpoint save/restore: step-atomic directories + async writer, the port
of ``src/repro/train/checkpoint.py``.

Fault-tolerance contract, as in the reference:
  * each checkpoint is a directory ``step_NNNNNNNN`` written under a
    ``.tmp`` name and atomically renamed, so a crash mid-write never
    corrupts the latest checkpoint;
  * ``restore_latest`` picks the newest complete checkpoint, so a restarted
    job (launcher ``--resume auto``) continues from the last good step;
  * ``AsyncCheckpointer`` moves serialization off the training thread and
    keeps the newest ``keep`` checkpoints;
  * leaves are raw ``.npy`` files plus a json manifest of their keys.

A tree is nested dicts of tensors and ``OptState`` tuples (step, master, m,
v); its leaves are keyed by their "/"-joined paths.  NumPy has no
bfloat16: a bf16 leaf is stored as its bits (``uint16``) with ``"dtype":
"bfloat16"`` in the manifest, and restored bit for bit.

Unlike the reference's JAX arrays, the port's parameters and optimizer
state are updated in place, so ``save_async`` copies every leaf to the
host on the calling thread before it returns: a writer that read the
tensors later would race the next step.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import re
import shutil
from pathlib import Path
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optim import OptState


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, OptState):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _flatten(val, f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def _unflatten_like(like: Any, leaves: dict, prefix: str = "") -> Any:
    if isinstance(like, OptState):
        return OptState(**_unflatten_like(like._asdict(), leaves, prefix))
    if isinstance(like, dict):
        return {key: _unflatten_like(val, leaves, f"{prefix}{key}/")
                for key, val in like.items()}
    return leaves[prefix[:-1]]


def _file_key(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_./-]", "_", key)


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor leaf as a numpy array (bf16 as
    ``uint16`` bits, tagged), taken now."""
    def leaf(t):
        t = torch.as_tensor(t).detach()
        tag = None
        if t.dtype == torch.bfloat16:
            tag, t = "bfloat16", t.view(torch.int16)
        arr = t.to("cpu", copy=True).numpy()     # one copy, from any device
        return tag, (arr.view(np.uint16) if tag else arr)
    if isinstance(tree, OptState):
        return OptState(*(to_host(x) for x in tree))
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return leaf(tree)


def save(ckpt_dir: str | Path, step: int, tree: Any) -> Path:
    """Write ``tree`` (tensors, or ``to_host``'s copy of them) as
    checkpoint ``step``: a ``.tmp`` directory, renamed when complete."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        tag, arr = leaf if isinstance(leaf, tuple) else to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest[_file_key(key)] = {"file": fname,
                                    "dtype": tag or str(arr.dtype),
                                    "shape": list(arr.shape)}
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic publish
    return final


def restore(path: str | Path, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf a tensor of the stored dtype on the device of ``like``'s leaf."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())["leaves"]
    leaves = {}
    for key, ref in _flatten(like):
        rec = manifest[_file_key(key)]
        arr = np.load(path / rec["file"])
        if rec["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if list(t.shape) != rec["shape"]:
            raise ValueError(f"{key}: stored {rec['shape']}, read "
                             f"{list(t.shape)}")
        leaves[key] = t.to(torch.as_tensor(ref).device)
    return _unflatten_like(like, leaves)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_latest(ckpt_dir: str | Path, like: Any
                   ) -> Tuple[Optional[int], Any]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None, like
    return step, restore(Path(ckpt_dir) / f"step_{step:08d}", like)


class AsyncCheckpointer:
    """One-deep async writer: snapshot on the caller, serialize off-thread,
    keep the newest ``keep`` checkpoints."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt")
        self._pending: Optional[cf.Future] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = to_host(tree)           # snapshot now, on this thread

        def job():
            save(self.ckpt_dir, step, host_tree)
            self._gc()

        self._pending = self._pool.submit(job)

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for p in self.ckpt_dir.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", p.name)))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}",
                          ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
