"""Checkpointing: atomic, async, keep-k, numerics-stamped.

Layout (the JAX package's)::

    <dir>/step_<n>/
        manifest.json   — tree structure + leaf metadata (+ numerics)
        leaf_<i>.npy    — one array per leaf (np.save), in tree order

* **Atomicity** — a save writes ``step_<n>.tmp`` and renames it into place
  only after the manifest is fsynced; a crashed writer never corrupts the
  latest checkpoint, and a directory without a manifest is refused.
* **Async** — ``CheckpointManager.save(..., blocking=False)`` copies the
  tensors to host memory first, then writes on a background thread.
* **Keep-k** — older steps are removed after a successful save, with any
  stale ``.tmp`` directories of crashed writers.
* **Deterministic resume** — the state carries ``step``; the data pipeline
  is seeded per step, so a restart replays exactly the batches not yet
  consumed.
* **Numerics-stamped manifests** — ``save_checkpoint(..., numerics=)``
  stores the canonical :class:`~repro_torch.core.plan.NumericsPlan`
  string; restoring under another arithmetic raises unless
  ``allow_numerics_mismatch=True`` (LNS weight codes mean something only
  under the format and Δ they were trained with).

Leaves are ordered and the manifest's ``treedef`` printed as in the JAX
package (:mod:`repro_torch.pytree`), so the two packages read each
other's checkpoints of the same tree.

* **Sharded trees** — under a mesh, ``shardings=`` (a tree of
  ``distributed.sharding.NamedSharding``, e.g. ``param_shardings``) makes
  a save gather the full leaves first (every rank takes part, rank 0
  writes), so the files are those of an unsharded save; a restore cuts
  each full leaf to this rank's shard on the current mesh, whatever mesh
  wrote it: the elastic restart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..pytree import tree_flatten, tree_unflatten, treedef_str


def _host(tree):
    """``(host numpy leaves, treedef)``: tensors copied to host memory,
    a CPU tensor too.  The copy is made before ``save`` returns, and the
    next step depends on it: a step built with ``donate=True`` (the train
    CLI's) writes its new state into these tensors, as the JAX package's
    device buffers "may be donated by the next step"."""
    leaves, treedef = tree_flatten(tree)
    return [t.detach().to("cpu", copy=True).numpy()
            if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in leaves], treedef


def _canonical_numerics(numerics) -> Optional[str]:
    """A spec or plan (string or object), canonicalized for the stamp."""
    if numerics is None:
        return None
    from ..core.plan import NumericsPlan
    return str(NumericsPlan.parse(numerics))


def _full_tree(tree, shardings):
    """The full leaves of a sharded tree (a collective over the mesh)."""
    from ..distributed.sharding import gather_tree, map_with_path
    return map_with_path(lambda _p, t, s: gather_tree(t, s.spec, s.mesh),
                         tree, shardings)


def _writer() -> bool:
    """Whether this process writes: rank 0, or no process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree, *,
                    numerics=None, shardings=None) -> str:
    """Atomic synchronous save of a tree of tensors or arrays; returns the
    final path.  ``numerics`` is canonicalized and stamped into the
    manifest.  With ``shardings`` every rank must call it; rank 0
    writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    if shardings is not None:
        tree = _full_tree(tree, shardings)
        if not _writer():
            return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    host, treedef = _host(tree)
    manifest = {
        "step": step,
        "treedef": treedef_str(treedef),
        "n_leaves": len(host),
        "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in host],
        "time": time.time(),
    }
    if numerics is not None:
        manifest["numerics"] = _canonical_numerics(numerics)
    for i, a in enumerate(host):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # The old checkpoint is renamed aside, the new one renamed in, and only
    # then is the old one deleted: a kill at any point leaves a complete
    # directory under ``final`` or under a ``.tmp`` name that GC removes
    # and restore ignores.
    old = final + ".old.tmp"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.replace(tmp, final)
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _torn(path, why):
    return ValueError(f"checkpoint {path} is torn/partial: {why}.  Writes "
                      f"are atomic (tmp dir + rename), so it was never a "
                      f"complete checkpoint — delete it and restore an "
                      f"earlier step.")


def load_checkpoint(directory: str, step: int, like, device=None, *,
                    shardings=None, numerics=None,
                    allow_numerics_mismatch: bool = False):
    """Restore a tree saved by :func:`save_checkpoint`.

    ``like`` gives the tree structure (a tree of tensors); each leaf is
    placed on ``device``, or on its ``like`` leaf's device when ``device``
    is None.  ``shardings`` (a tree of ``NamedSharding`` on the current
    mesh) cuts each full leaf to this rank's shard.  When both
    ``numerics`` and the manifest's stamp are present and their canonical
    plan strings differ, the restore raises unless
    ``allow_numerics_mismatch``; an unstamped checkpoint restores without
    the check.
    """
    path = os.path.join(directory, f"step_{step:08d}")
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise _torn(path, "no manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise _torn(path, f"manifest.json is not valid JSON ({e})") from e
    want = _canonical_numerics(numerics)
    have = manifest.get("numerics")
    if want is not None and have is not None and want != have \
            and not allow_numerics_mismatch:
        from ..core.plan import plan_diff
        raise ValueError(
            f"checkpoint {path} was saved under numerics {have!r} but is "
            f"being restored under {want!r}; LNS codes are not portable "
            f"across arithmetics.  Re-run with the matching --numerics, "
            f"or pass allow_numerics_mismatch=True (CheckpointManager("
            f"allow_numerics_mismatch=True)) for a deliberate format "
            f"migration.\n"
            + plan_diff(have, want, labels=("saved", "requested")))
    leaves, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree has {len(leaves)}")
    missing = [f"leaf_{i}.npy" for i in range(len(leaves))
               if not os.path.exists(os.path.join(path, f"leaf_{i}.npy"))]
    if missing:
        raise _torn(path, f"the manifest promises {manifest['n_leaves']} "
                          f"leaves but {missing} are missing")
    out = []
    for i, ref in enumerate(leaves):
        a = np.load(os.path.join(path, f"leaf_{i}.npy"))
        dev = device if device is not None else ref.device
        out.append(torch.from_numpy(a).to(dev))
    out = tree_unflatten(treedef, out)
    if shardings is not None:
        from ..distributed.sharding import local_shard, map_with_path
        out = map_with_path(lambda _p, t, s: local_shard(t, s.spec, s.mesh),
                            out, shardings)
    return out


class CheckpointManager:
    """Keep-k async checkpointer with crash-safe GC.

    ``numerics`` is stamped into every manifest this manager writes and
    checked on every restore (see :func:`load_checkpoint`).
    """

    def __init__(self, directory: str, keep: int = 3, *, numerics=None,
                 allow_numerics_mismatch: bool = False):
        self.directory = directory
        self.keep = keep
        # Canonicalized here: a malformed string must fail in the caller,
        # not inside the writer thread.
        self.numerics = _canonical_numerics(numerics)
        self.allow_numerics_mismatch = allow_numerics_mismatch
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, blocking: bool = True, shardings=None):
        """With ``shardings`` every rank calls it: the full leaves are
        gathered here, and rank 0 writes."""
        self.wait()
        if shardings is not None:
            tree = _full_tree(tree, shardings)
            if not _writer():
                return
        # Copy to the host before returning: the caller's next step may
        # write its new state into these tensors (donate=True).
        host, treedef = _host(tree)
        snapshot = tree_unflatten(treedef, host)

        def write():
            save_checkpoint(self.directory, step, snapshot,
                            numerics=self.numerics)
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:  # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the background writer; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like, device=None, shardings=None):
        """``(tree, step)`` of the newest complete checkpoint, or ``(None,
        None)``; ``shardings`` as :func:`load_checkpoint`'s."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return load_checkpoint(
            self.directory, step, like, device, shardings=shardings,
            numerics=self.numerics,
            allow_numerics_mismatch=self.allow_numerics_mismatch), step

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        for d in os.listdir(self.directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
