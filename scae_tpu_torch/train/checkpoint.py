"""Checkpoints and resume (counterpart of scae_tpu/train/checkpoint.py).

The JAX package keeps its checkpoints with Orbax; the port rebuilds the
part of Orbax's ``CheckpointManager`` that the training loop uses over
``torch.save``, with the same retention rules:

  * a save at a step not after the latest kept one is refused (returns
    False);
  * every checkpoint carries its metrics; with a monitor, the best
    ``max_to_keep`` by the monitored value (``mode`` "min" or "max") are
    kept, the rest deleted after each save, ties going to the later step;
  * a checkpoint written under the legacy key "loss" scores by it when the
    monitor is "loss" or "val_loss"; one with no comparable metric ranks
    worst (+inf under "min", -inf under "max");
  * ``latest_step`` is the newest kept checkpoint, ``best_step`` the best.

A checkpoint is the directory ``<directory>/<step>/`` holding
``checkpoint.pt`` (the model's ``state_dict``, the optimizer's state,
Lookahead's slow weights included, the step count and the seed, all as CPU
tensors and ints) and ``metrics.json``. It is written under a temporary
name and renamed into place. Saves are synchronous, so ``wait`` has
nothing to wait for. The port does not read Orbax trees.
"""

import json
import os
import shutil
from typing import Dict, List, Optional

import torch

_STATE = "checkpoint.pt"
_METRICS = "metrics.json"


def _score(metrics: Dict, monitor: str, mode: str) -> float:
    if monitor in metrics:
        return metrics[monitor]
    # checkpoints written before the monitor was configurable store the
    # monitored value under "loss", comparable only when the monitor IS
    # the loss
    if monitor in ("loss", "val_loss") and "loss" in metrics:
        return metrics["loss"]
    # no comparable metric (e.g. the monitor changed between runs): worst
    return float("-inf") if mode == "max" else float("inf")


def _cpu_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def state_payload(state) -> dict:
    """What a checkpoint holds of a ``TrainState``, as CPU copies: the
    model's ``state_dict``, the optimizer's state, the step and the seed."""
    return {"model": _cpu_state_dict(state.model),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "seed": int(state.seed)}


def load_payload(state, payload: dict):
    """Copy ``payload`` (``state_payload``'s) into ``state`` in place, onto
    the model's own device, and return ``state``."""
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 monitor: str = "loss", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.refresh()

    def refresh(self):
        """Read the kept checkpoints from the directory anew (another
        process, process 0 of a mesh, may have written or deleted some)."""
        self._metrics: Dict[int, Dict] = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.isdigit() and os.path.exists(os.path.join(path, _STATE)):
                self._metrics[int(name)] = self._read_metrics(path)

    @staticmethod
    def _read_metrics(path: str) -> Dict:
        metrics_path = os.path.join(path, _METRICS)
        if not os.path.exists(metrics_path):
            return {}
        with open(metrics_path) as f:
            return json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _ranked(self) -> List[int]:
        """Kept steps from worst to best (ties: the earlier step first)."""
        steps = sorted(self._metrics)
        if not self.monitor:
            return steps
        return sorted(steps, key=lambda s: _score(
            self._metrics[s], self.monitor, self.mode),
            reverse=self.mode == "min")

    def save(self, step: int, state, metrics: Optional[dict] = None) -> bool:
        """Save ``state`` (a ``TrainState``, a zero-argument function
        returning one, or a payload as ``state_payload`` makes it) at
        ``step`` with its metrics; False, and nothing written, unless
        ``step`` is after the latest kept checkpoint."""
        step = int(step)
        latest = self.latest_step
        if latest is not None and latest >= step:
            return False
        if callable(state):
            state = state()
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        payload = state if isinstance(state, dict) else state_payload(state)
        path = self._path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _METRICS), "w") as f:
            json.dump(metrics, f)
        os.replace(tmp, path)
        self._metrics[step] = metrics
        ranked = self._ranked()
        for old in ranked[:max(len(ranked) - self.max_to_keep, 0)]:
            shutil.rmtree(self._path(old))
            del self._metrics[old]
        return True

    def read_payload(self, step: Optional[int] = None) -> dict:
        """Checkpoint ``step`` (default: the latest) as ``state_payload``
        made it, on the CPU."""
        step = self.latest_step if step is None else int(step)
        if step is None or step not in self._metrics:
            raise FileNotFoundError(f"no checkpoint {step} in "
                                    f"{self.directory}")
        return torch.load(os.path.join(self._path(step), _STATE),
                          map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state``, a
        ``TrainState`` of the same model and optimizer, in place (onto the
        model's own device), and return it."""
        return load_payload(state, self.read_payload(step))

    def restore_params(self, step: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` alone (CPU tensors), with no
        ``TrainState`` needed: the source run may have used another
        optimizer."""
        return self.read_payload(step)["model"]

    def metrics(self, step: int) -> Optional[dict]:
        return self._metrics.get(int(step))

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None

    @property
    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def wait(self):
        pass

    def close(self):
        pass


class NullCheckpointManager:
    """`trainer.save_top_k: 0`: checkpointing disabled.

    Keeps the directory (the loop records train_seed.json there) and the
    full manager surface so the training loop needs no branching.
    """

    def __init__(self, directory: str):
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        self.directory = directory

    def refresh(self):
        pass

    def save(self, step, state, metrics=None) -> bool:
        return False

    def restore(self, state, step=None):
        raise AssertionError("checkpointing disabled (save_top_k=0)")

    def restore_params(self, step=None):
        raise AssertionError("checkpointing disabled (save_top_k=0)")

    def metrics(self, step):
        return None

    @property
    def latest_step(self):
        return None

    @property
    def best_step(self):
        return None

    def wait(self):
        pass

    def close(self):
        pass
