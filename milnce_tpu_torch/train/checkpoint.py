"""Checkpoint save/rotate/resume (port of ``milnce_tpu/train/checkpoint.py``).

Same semantics as the reference (main_distributed.py:192-200, 289-302)
and the JAX manager: one checkpoint per epoch label, a sliding retention
window (default 10), resume from the newest.  Label ``n`` is the
directory ``<directory>/<n>/`` holding one ``torch.save`` file: the
model ``state_dict`` in the reference layout (so
``utils/torch_convert.py`` maps it), the optimizer, the LR scheduler,
the step (batches consumed) and the epoch label.  A save writes a
temporary directory and renames it into place, so a label on disk is
always whole.  Orbax checkpoints of the JAX package are not read.

As the JAX manager (Orbax), a save that is not forced and whose label is
not newer than the latest on disk is skipped.

A checkpoint holds full, plain tensors and no layout (the JAX
docstring): on the 2-D layout :func:`train_state` gathers the sharded
parameters and their Adam moments to full tensors (every rank calls it;
rank 0 saves), and :func:`load_train_state` slices them back, so any
layout's checkpoint opens on any other (1-D, 2-D, one process).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Optional, Tuple

import torch

from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.train.state import load_optimizer_state

# Transient-save-failure telemetry: nonzero retries on a healthy store is
# the early-warning signal for flaky storage.
_OBS_SAVE_RETRIES = obs_metrics.registry().counter(
    "milnce_ckpt_save_retries_total",
    "checkpoint save submits retried after a transient OSError")

_STALE_PREFIX = "stale-epoch-"   # non-numeric => invisible to latest_epoch
_TMP_PREFIX = ".tmp-"
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 10, create: bool = True,
                 save_retries: int = 2, retry_backoff: float = 0.25):
        """``create=False`` opens read-only and raises on a missing
        directory — an eval of a mistyped path must not mkdir it and
        silently score fresh weights.

        ``save_retries``/``retry_backoff``: an OSError while writing is
        retried after ``retry_backoff * 2**attempt`` seconds, so one
        transient write error does not lose the partial epoch."""
        self._directory = os.path.abspath(directory)
        self.keep = int(keep)
        self.save_retries = max(0, int(save_retries))
        self.retry_backoff = float(retry_backoff)
        self._writable = create
        if create:
            os.makedirs(self._directory, exist_ok=True)
            self._recover_interrupted_replacements()
        elif not os.path.isdir(self._directory):
            raise FileNotFoundError(
                f"checkpoint directory not found: {self._directory!r}")

    def _path(self, epoch: int) -> str:
        return os.path.join(self._directory, str(int(epoch)))

    def _recover_interrupted_replacements(self) -> None:
        """Finish any forced replacement that a kill interrupted: the old
        label is moved aside to ``stale-epoch-<n>`` before its successor
        is renamed into place.  If label ``<n>`` exists again the new save
        committed and the backup is garbage; if not, the backup goes back.
        Half-written temporary directories are dropped."""
        for name in os.listdir(self._directory):
            path = os.path.join(self._directory, name)
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(path)
                continue
            m = re.fullmatch(_STALE_PREFIX + r"(\d+)", name)
            if not m:
                continue
            if os.path.isdir(self._path(int(m.group(1)))):
                shutil.rmtree(path)
            else:
                os.rename(path, self._path(int(m.group(1))))

    def all_epochs(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self._directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self._directory, name, STATE_FILE)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def _write_with_retry(self, epoch: int, state: dict) -> str:
        """torch.save into a fresh temporary directory; only OSError is
        retried (the ``ckpt.save_ioerror`` fault site fires inside the
        retry, as in the JAX manager)."""
        tmp = os.path.join(self._directory, f"{_TMP_PREFIX}{epoch}")
        for attempt in range(self.save_retries + 1):
            try:
                faults.maybe_raise("ckpt.save_ioerror", OSError)
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                torch.save(state, os.path.join(tmp, STATE_FILE))
                return tmp
            except OSError as exc:
                if attempt >= self.save_retries:
                    raise
                _OBS_SAVE_RETRIES.inc()
                delay = self.retry_backoff * (2 ** attempt)
                logging.getLogger(__name__).warning(
                    "checkpoint save of epoch %d failed (%s: %s); retrying "
                    "in %.2fs (attempt %d/%d)", epoch, type(exc).__name__,
                    exc, delay, attempt + 1, self.save_retries)
                time.sleep(delay)

    def save(self, epoch: int, state: dict, force: bool = False) -> bool:
        """Save ``state`` under label ``epoch``; returns whether it was
        written.  Not forced, a label not newer than the latest is skipped
        (the JAX manager's rule).  ``force=True`` is for mid-epoch stops
        labeled with the current epoch, whose boundary save may already
        hold the label: the stale copy is moved aside, the new one renamed
        into place, and only then is the stale copy removed — a kill
        anywhere in between leaves one of the two recoverable."""
        if not self._writable:
            raise PermissionError(f"{self._directory} was opened read-only")
        epoch = int(epoch)
        latest = self.latest_epoch()
        if not force and latest is not None and epoch <= latest:
            return False
        tmp = self._write_with_retry(epoch, state)
        final = self._path(epoch)
        stale = os.path.join(self._directory, f"{_STALE_PREFIX}{epoch}")
        replacing = os.path.isdir(final)
        if replacing:
            os.rename(final, stale)
        os.rename(tmp, final)
        if replacing:
            shutil.rmtree(stale)
        epochs = self.all_epochs()
        if self.keep > 0:
            for old in epochs[:-self.keep]:
                shutil.rmtree(self._path(old))
        return True

    def restore(self, epoch: int, map_location="cpu",
                mmap: bool = False) -> dict:
        """The state saved under label ``epoch``.  ``mmap=True`` maps the
        file instead of reading it: a tensor's bytes are read only when
        it is used, so a reader of the model alone (eval, export) never
        reads the optimizer's moments."""
        return torch.load(os.path.join(self._path(epoch), STATE_FILE),
                          map_location=map_location, weights_only=True,
                          mmap=mmap)

    def restore_latest(self, map_location="cpu") -> Tuple[int, Optional[dict]]:
        """(label, state) of the newest checkpoint; (0, None) when nothing
        is saved (main_distributed.py:296-302)."""
        latest = self.latest_epoch()
        if latest is None:
            return 0, None
        return latest, self.restore(latest, map_location)

    def restore_model(self, epoch: Optional[int] = None
                      ) -> Tuple[int, int, dict]:
        """(label, step, model state_dict) on the CPU, label ``epoch`` or
        the newest: the file is memory-mapped, so only the model's
        tensors are read, never the optimizer's moments."""
        label = epoch if epoch is not None else self.latest_epoch()
        if label is None:
            raise FileNotFoundError(
                f"no checkpoint saved in {self._directory}")
        state = self.restore(label, mmap=True)
        return label, int(state.get("step", label)), state["model"]

    def restore_raw(self, epoch: Optional[int] = None) -> Tuple[int, dict]:
        """(label, model state_dict) on the CPU: the weights alone, for
        eval and export."""
        label, _, model = self.restore_model(epoch)
        return label, model


def train_state(model, optimizer, lr_scheduler, step: int,
                epoch: int, placement=None) -> dict:
    """What a checkpoint holds (see the module docstring); with a 2-D
    ``placement``, a collective of every rank."""
    if placement is not None:
        model_sd, opt_sd = placement.full_state(model, optimizer)
    else:
        model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    return {"model": model_sd, "optimizer": opt_sd,
            "scheduler": lr_scheduler.state_dict(), "step": int(step),
            "epoch": int(epoch)}


def load_train_state(state: dict, model, optimizer, lr_scheduler,
                     placement=None) -> int:
    """Load a checkpoint's model, optimizer and scheduler in place (into
    a 2-D ``placement``'s slices when given); returns its step."""
    if placement is not None:
        placement.load_full_state(model, optimizer, state["model"],
                                  state["optimizer"])
    else:
        model.load_state_dict(state["model"])
        load_optimizer_state(optimizer, state["optimizer"])
    lr_scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])
