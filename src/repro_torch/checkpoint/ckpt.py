"""Checkpointing: atomic, restart-safe, with the JAX package's layout.

The port of ``repro.checkpoint.ckpt``. Layout per checkpoint:
<dir>/step_<N>/
    arrays.npz   — every leaf of the tree under its path, the keys of
                   nested dicts and the indices of lists joined with
                   ``"||"`` (the port's state names stay whole:
                   ``params||blocks.0.mixer.wq.w``); bf16 stored as a
                   uint16 view, the true dtype recorded in meta
    meta.json    — step, leaf dtypes

Properties:
  * atomic publish (write to a ``.tmp_step_<N>`` dir, rename) — a crash
    mid-save never corrupts the latest checkpoint; ``keep_last`` older
    checkpoints are kept, stale temporaries removed;
  * leaves are saved whole on the host, so a restore may put them on
    another device;
  * ``AsyncCheckpointer`` overlaps serialization and IO with training:
    the snapshot (a host copy of every leaf) is taken on the caller's
    thread, since training then updates the tensors in place; the IO
    runs in the background, at most one save outstanding, and its error
    is raised at the next ``wait()``.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

Tree = Any

_SEP = "||"


def _flatten(tree: Tree, path: tuple = ()):
    """(path, leaf) pairs of nested dicts (in their order) and lists."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, path + (str(i),))
    else:
        yield path, tree


def _unflatten_like(like: Tree, leaves: dict, path: tuple = ()) -> Tree:
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, path + (str(i),))
                          for i, v in enumerate(like))
    return leaves[path]


def _snapshot(tree: Tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Host copies of the leaves as numpy arrays (bf16 viewed as uint16)
    and their dtypes."""
    arrays: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for path, leaf in _flatten(tree):
        key = _SEP.join(path)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                dtypes[key] = "bfloat16"
                arrays[key] = t.view(torch.uint16).numpy()
                continue
            arr = t.numpy()
        else:
            arr = np.array(leaf)
        dtypes[key] = str(arr.dtype)
        arrays[key] = arr
    return arrays, dtypes


def _publish(directory: Path, step: int, arrays: dict[str, np.ndarray],
             dtypes: dict[str, str], keep_last: int) -> Path:
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, "dtypes": dtypes, "fmt": 1}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _cleanup(directory, keep_last)
    return final


def save(directory: str | Path, step: int, tree: Tree,
         keep_last: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = _snapshot(tree)
    return _publish(directory, step, arrays, dtypes, keep_last)


def _cleanup(directory: Path, keep_last: int) -> None:
    ckpts = sorted(d for d in directory.iterdir()
                   if d.is_dir() and d.name.startswith("step_"))
    for old in ckpts[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    for stale in directory.iterdir():
        if stale.name.startswith(".tmp_step_"):
            shutil.rmtree(stale, ignore_errors=True)


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in directory.iterdir()
             if d.is_dir() and d.name.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str | Path, step: int, like: Tree,
            shardings: Tree | None = None) -> Tree:
    """The checkpoint of ``step`` in the structure of ``like`` (a tree of
    tensors): each leaf a new tensor with the dtype and on the device of
    ``like``'s leaf at the same path. With ``shardings`` (a tree of the
    same structure whose leaves are ``repro_torch.distributed.sharding
    .NamedSharding``s, or None for a whole leaf), each leaf is this
    rank's block under its placement — the mesh may differ from the one
    that saved (elastic restart): checkpoints hold whole tensors."""
    ckpt_dir = Path(directory) / f"step_{step:08d}"
    meta = json.loads((ckpt_dir / "meta.json").read_text())
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    leaves = {}
    with np.load(ckpt_dir / "arrays.npz") as data:
        for path, leaf in _flatten(like):
            key = _SEP.join(path)
            arr = data[key]
            if meta["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.uint16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            sh = placed.get(path)
            if sh is not None:
                t = sh.shard(t).contiguous()
            leaves[path] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _unflatten_like(like, leaves)


class AsyncCheckpointer:
    """Overlap checkpoint IO with training (one outstanding save)."""

    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        # snapshot on the caller thread (consistent view), IO in background
        arrays, dtypes = _snapshot(tree)
        self.directory.mkdir(parents=True, exist_ok=True)

        def work():
            try:
                _publish(self.directory, step, arrays, dtypes,
                         self.keep_last)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
