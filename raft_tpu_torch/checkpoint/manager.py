"""Training checkpoints and resume, as torch files.

Ported from the JAX package's ``raft_tpu/checkpoint/manager.py``, which
keeps Orbax step directories. The port keeps the same layout and rules
with ``torch.save`` files: one directory per saved step,
``<root>/<step>/state.pt`` holding :meth:`TrainState.state_dict`
(parameters, BatchNorm buffers, the optimizer's count and moments, the
step counters), ``max_to_keep`` of them retained (3 in the Trainer), saves
only on the interval unless forced.

  * Writes are atomic: the file goes to a temporary directory beside the
    step's, is flushed to disk, then the directory is renamed into place,
    so a kill mid-write leaves no step directory.
  * Restores are validated (:func:`validate_restored`: the same keys,
    shapes and dtypes as the live state, and a finite spot check of
    float tensors) and fall back through the retained steps: a step that
    fails to load or validate is moved under ``<root>/quarantined/`` and
    the next newest is tried; when none restores,
    :class:`~raft_tpu_torch.utils.faults.CheckpointRestoreError` names
    every attempt.
  * ``known_good.json`` tags rollback targets (``train.stability``):
    :meth:`CheckpointManager.restore_known_good` walks tagged steps
    newest first, then the rest.

Saves are synchronous (Orbax's are asynchronous): the state is copied to
the host, which syncs the device, at checkpoint boundaries only.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any, Dict, List, Optional

import torch

from raft_tpu_torch.utils.faults import CheckpointRestoreError

__all__ = ["CheckpointManager", "validate_restored"]

_KNOWN_GOOD = "known_good.json"
_STATE_FILE = "state.pt"
# elements finite-checked from each end of a large tensor (small ones in
# full): torn payloads are block-shaped, so a spot check finds them
_SPOT_CHECK_ELEMS = 4096


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {f"{prefix}#len": len(tree)}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def validate_restored(template: Dict, restored: Dict, *, step: int) -> None:
    """Raise :class:`CheckpointRestoreError` unless ``restored`` (a loaded
    state_dict) has ``template``'s structure, every tensor its shape and
    dtype, and its float tensors pass a finite spot check."""
    t_flat, r_flat = _flatten(template), _flatten(restored)
    if set(t_flat) != set(r_flat):
        missing, extra = sorted(set(t_flat) - set(r_flat)), sorted(set(r_flat) - set(t_flat))
        raise CheckpointRestoreError(
            f"step {step}: restored state does not match the live one (missing {missing[:5]}, "
            f"unexpected {extra[:5]})"
        )
    for name, t_leaf in t_flat.items():
        r_leaf = r_flat[name]
        if not isinstance(t_leaf, torch.Tensor):
            if t_leaf != r_leaf:
                raise CheckpointRestoreError(f"step {step}: {name} is {r_leaf}, want {t_leaf}")
            continue
        if not isinstance(r_leaf, torch.Tensor):
            raise CheckpointRestoreError(f"step {step}: {name} is a {type(r_leaf).__name__}, want a tensor")
        if r_leaf.shape != t_leaf.shape:
            raise CheckpointRestoreError(f"step {step}: {name} has shape {tuple(r_leaf.shape)}, "
                                         f"want {tuple(t_leaf.shape)}")
        if r_leaf.dtype != t_leaf.dtype:
            raise CheckpointRestoreError(f"step {step}: {name} has dtype {r_leaf.dtype}, want {t_leaf.dtype}")
        if not r_leaf.is_floating_point():
            continue
        flat = r_leaf.reshape(-1)
        if flat.numel() > 2 * _SPOT_CHECK_ELEMS:
            flat = torch.cat([flat[:_SPOT_CHECK_ELEMS], flat[-_SPOT_CHECK_ELEMS:]])
        if not bool(torch.isfinite(flat.float()).all()):
            raise CheckpointRestoreError(f"step {step}: nonfinite values in restored tensor {name}")


class CheckpointManager:
    """Step directories of torch files under ``directory``.

    Args:
        directory: checkpoint root (created if missing).
        max_to_keep: retention count.
        save_interval_steps: ``save`` off the interval is a no-op unless
            forced.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.quarantined_steps: List[int] = []
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Save ``state`` (a :class:`TrainState`) at ``step``; returns
        whether it saved. Off the interval, or at or before the latest
        saved step, only ``force`` saves; a step already on disk raises."""
        step = int(step)
        latest = self.latest_step()
        if not force and (step % self.save_interval_steps or (latest is not None and step <= latest)):
            return False
        final = self._step_dir(step)
        if os.path.exists(final):
            raise ValueError(f"checkpoint step {step} already exists in {self.directory}")
        tmp = os.path.join(self.directory, f".{step}.tmp-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            path = os.path.join(tmp, _STATE_FILE)
            with open(path, "wb") as f:
                torch.save(state.state_dict(), f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in sorted(self.all_steps())[: -self.max_to_keep]:
            self.delete(old)
        return True

    def _load(self, step: int) -> Dict:
        return torch.load(os.path.join(self._step_dir(step), _STATE_FILE), map_location="cpu", weights_only=True)

    def restore(self, state, *, step: Optional[int] = None, validate: bool = True, fallback: bool = True):
        """Restore into ``state`` (a :class:`TrainState`, changed in place
        and returned): the latest retained step by default, ``None`` when
        there is none. A step that fails to load or validate is
        quarantined and the next newest tried (``fallback``); an explicit
        ``step`` pins the restore."""
        if step is not None:
            restored = self._load(step)
            if validate:
                validate_restored(state.state_dict(), restored, step=step)
            state.load_state_dict(restored)
            return state
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        return self._walk_restore(state, steps, validate=validate, fallback=fallback)

    def restore_known_good(self, state, *, before: Optional[int] = None):
        """Restore the newest known-good retained step (a rollback target):
        tagged steps newest first, then the untagged ones, each under the
        same validation and quarantine as :meth:`restore`. ``before``
        excludes steps ``>= before`` (unless that leaves none)."""
        steps = sorted(self.all_steps(), reverse=True)
        if before is not None:
            steps = [s for s in steps if s < before] or steps
        if not steps:
            return None
        good = self.good_steps()
        ordered = [s for s in steps if s in good] + [s for s in steps if s not in good]
        return self._walk_restore(state, ordered, validate=True, fallback=True)

    def _walk_restore(self, state, steps: List[int], *, validate: bool, fallback: bool):
        attempts = []
        template = state.state_dict() if validate else None
        for s in steps:
            try:
                restored = self._load(s)
                if validate:
                    validate_restored(template, restored, step=s)
                state.load_state_dict(restored)
                return state
            except Exception as e:
                if not fallback:
                    raise
                attempts.append((s, f"{type(e).__name__}: {e}"))
                self._quarantine(s, e)
        raise CheckpointRestoreError(
            f"no retained checkpoint in {self.directory} restored cleanly; attempts (newest first): "
            + "; ".join(f"step {s}: {err}" for s, err in attempts),
            attempts,
        )

    # -- known-good tagging (train.stability rollback targets) -------------

    def _good_path(self) -> str:
        return os.path.join(self.directory, _KNOWN_GOOD)

    def good_steps(self) -> Dict[int, Dict]:
        """``{step: meta}`` of tagged steps (a missing or corrupt file is
        ``{}``)."""
        try:
            with open(self._good_path()) as f:
                raw = json.load(f)
            return {int(k): dict(v) for k, v in raw.items()}
        except (OSError, ValueError, TypeError, AttributeError):
            return {}

    def _write_good(self, good: Dict[int, Dict]) -> None:
        tmp = self._good_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(s): m for s, m in sorted(good.items())}, f)
        os.replace(tmp, self._good_path())

    def tag_good(self, step: int, meta: Optional[Dict] = None) -> None:
        """Tag ``step`` as a known-good rollback target (atomic replace);
        tags of steps retention has deleted are dropped."""
        good = self.good_steps()
        good[int(step)] = dict(meta or {})
        retained = set(self.all_steps())
        newest = max(retained, default=-1)
        self._write_good({s: m for s, m in good.items() if s in retained or s > newest})

    def untag_good(self, step: int) -> None:
        good = self.good_steps()
        if int(step) in good:
            del good[int(step)]
            self._write_good(good)

    def _quarantine(self, step: int, exc: BaseException) -> None:
        """Move a damaged step under ``quarantined/`` so neither this walk
        nor a later resume trips over it again."""
        src = self._step_dir(step)
        dst_root = os.path.join(self.directory, "quarantined")
        if os.path.isdir(src):
            os.makedirs(dst_root, exist_ok=True)
            dst = os.path.join(dst_root, str(step))
            n = 0
            while os.path.exists(dst):
                n += 1
                dst = os.path.join(dst_root, f"{step}.{n}")
            shutil.move(src, dst)
        self.quarantined_steps.append(step)
        try:
            self.untag_good(step)
        except OSError:
            pass
        print(f"checkpoint: quarantined corrupt step {step} ({type(exc).__name__}: {exc})")

    def delete(self, step: int) -> None:
        """Drop a retained step and its known-good tag."""
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        try:
            self.untag_good(step)
        except OSError:
            pass

    def all_steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isdir(os.path.join(self.directory, name))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None
