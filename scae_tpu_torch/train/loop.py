"""Training harness (counterpart of scae_tpu/train/loop.py): the
device-side batch functions ``make_augment_fn`` and ``make_center_pad_fn``,
and the ``Trainer`` behind ``python -m scae_tpu_torch.train.cli``.

The Trainer runs the JAX package's loop on one device: the model from the
factory (``cfg["model"]``), the harness' optimizer (rmsprop, radam or adam,
eps 1e-2/B^2, optional LookAhead, per-epoch exponential decay), the
training split on the device with only (K, B) index chunks crossing from
the host, on-device pad and translate, per-chunk loss-term logging under
the reference's metric names, val epoch means, the three validation image
grids, top-k checkpoints, deterministic resume and ``run_test`` on the full
test split with per-class recall.

It keeps the JAX loop's index stream (``np.random.RandomState(seed +
epoch).permutation``), chunk merge rule, double-buffered logging and
eval / checkpoint / ``train_seed.json`` cadence, so that a port run
consumes the same batches as a JAX run.

Not ported yet, and refused with ``NotImplementedError`` naming the key
when the config asks for them: ``trainer.seed_probe`` (``probe_seeds``),
``trainer.template_init``, ``init_from``, ``trainer.head_refit``
(``refit_head``), and a ``trainer.mesh`` of more than one device.
"""

import copy
import functools
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from scae_tpu_torch import factory
from scae_tpu_torch.models.layers import init_parameters
from scae_tpu_torch.optim import make_optimizer
from scae_tpu_torch.parallel.train_step import (
    TrainState,
    make_eval_scan,
    make_train_scan,
)
from scae_tpu_torch.train import data as data_lib
from scae_tpu_torch.train.checkpoint import (CheckpointManager,
                                             NullCheckpointManager)
from scae_tpu_torch.train.metrics import (
    MetricsWriter,
    Profiler,
    viz_grid_tensors,
    write_reconstruction_grids,
)
from scae_tpu_torch.utils.device import resolve_device


def make_augment_fn(canvas: int, max_shift: int, degrees: float = 0.0,
                    scale_jitter: float = 0.0):
    """``augment(batch, generator) -> batch``: pad to ``canvas``, then a
    random rotation and zoom when ``degrees`` or ``scale_jitter`` is set,
    then a random translation by up to ``max_shift`` pixels, all drawn from
    ``generator`` in that order. ``batch`` is {"image": (B, C, h, w), ...};
    other entries pass through."""

    def augment(batch, generator: torch.Generator):
        images = batch["image"]
        if canvas and images.shape[-1] != canvas:
            images = data_lib.pad_to_canvas(images, canvas)
        if degrees or scale_jitter:
            images = data_lib.random_affine(images, generator, degrees,
                                            scale_jitter)
        if max_shift:
            images = data_lib.random_translate(images, generator, max_shift)
        return {**batch, "image": images}

    return augment


def make_center_pad_fn(canvas: int):
    """``pad(batch) -> batch``: centre-pad the images to ``canvas``."""

    def pad(batch):
        images = batch["image"]
        if canvas and images.shape[-1] != canvas:
            images = data_lib.pad_to_canvas(images, canvas)
        return {**batch, "image": images}

    return pad


def _refuse_deferred(cfg: Dict):
    """Raise NotImplementedError for every config key whose feature the
    port does not have yet, rather than ignore it."""
    trainer_cfg = cfg.get("trainer") or {}
    asked = []
    if cfg.get("init_from"):
        asked.append("init_from (warm start)")
    if trainer_cfg.get("template_init") is not None:
        asked.append("trainer.template_init")
    if trainer_cfg.get("head_refit"):
        asked.append("trainer.head_refit")
    if int((trainer_cfg.get("seed_probe") or {}).get("n", 0) or 0) > 0:
        asked.append("trainer.seed_probe (probe_seeds)")
    mesh = trainer_cfg.get("mesh") or {}
    if mesh.get("n_data") not in (None, 1) or mesh.get("n_model") not in (
            None, 1):
        asked.append("trainer.mesh of more than one device")
    if asked:
        raise NotImplementedError(
            "not ported to scae_tpu_torch yet: " + ", ".join(asked))


class Trainer:
    def __init__(self, cfg: Dict, device=None):
        _refuse_deferred(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_cfg = dict(cfg["model"])
        self.model = factory.make_scae(self.model_cfg, device=self.device,
                                       seed=cfg.get("seed", 42))
        # a reconstruct-alternatives view for visualization: a shallow copy
        # shares the trained model's submodules and parameters
        self.viz_model = copy.copy(self.model)
        self.viz_model.reconstruct_alternatives = True

        trainer_cfg = cfg["trainer"]
        self.batch_size = cfg["data_loader"]["batch_size"]
        # when set, the data (content + splits) is keyed independently
        # of the run seed — see data.load_datasets(split_seed=...)
        self.split_seed = cfg["data_loader"].get("split_seed")

        self.log_dir = trainer_cfg.get("log_dir", "./logs")
        self.writer = MetricsWriter(self.log_dir)
        self.monitor = trainer_cfg.get("monitor", "val_loss")
        self.monitor_mode = trainer_cfg.get("monitor_mode", "min")
        _top_k = trainer_cfg.get("save_top_k", 3)
        _ckpt_dir = trainer_cfg.get("checkpoint_dir", "./checkpoints")
        if _top_k <= 0:
            self.ckpt = NullCheckpointManager(_ckpt_dir)
        else:
            self.ckpt = CheckpointManager(
                _ckpt_dir, max_to_keep=_top_k,
                monitor=self.monitor, mode=self.monitor_mode)

        aug = trainer_cfg.get("augment") or {}
        model_hw = cfg["model"]["image_shape"][-1]
        _canvas = aug.get("canvas")
        self.canvas = model_hw if _canvas is None else _canvas
        if self.canvas != model_hw:
            raise ValueError(
                f"trainer.augment.canvas={self.canvas} but the model "
                f"consumes {model_hw}x{model_hw} images "
                "(model.image_shape); set canvas to null to derive it")
        self.max_shift = aug.get("max_shift", 0)
        self.aug_degrees = aug.get("degrees", 0.0) or 0.0
        self.aug_scale_jitter = aug.get("scale_jitter", 0.0) or 0.0
        self.center_pad = make_center_pad_fn(self.canvas)

        prof = trainer_cfg.get("profile") or {}
        self.profiler = Profiler(self.log_dir,
                                 start_step=prof.get("start_step", -1),
                                 n_steps=prof.get("n_steps", 3))

    def build_steps(self, steps_per_epoch: int):
        # idempotent per steps_per_epoch
        if getattr(self, "_built_spe", None) == steps_per_epoch:
            return
        self._built_spe = steps_per_epoch
        opt_cfg = self.cfg["optimizer"]
        la = self.cfg.get("lookahead") or {}
        # the optimizer over the model's parameters, made fresh by
        # init_state (its state is part of the train state)
        self.tx = functools.partial(
            make_optimizer,
            name=opt_cfg["name"],
            learning_rate=opt_cfg["learning_rate"],
            batch_size=self.batch_size,
            momentum=opt_cfg.get("momentum", 0.9),
            use_lookahead=self.cfg.get("use_lookahead", False),
            lookahead_alpha=la.get("alpha", 0.5),
            lookahead_k=la.get("k", 6),
            lr_decay_rate=(self.cfg.get("lr_scheduler") or {})
            .get("decay_rate"),
            decay_steps=steps_per_epoch,
        )
        augment = make_augment_fn(self.canvas, self.max_shift,
                                  degrees=self.aug_degrees,
                                  scale_jitter=self.aug_scale_jitter)
        # K train steps per call on device-resident data; one host sync
        # per chunk, when its metrics are read
        self.train_scan = make_train_scan(augment_fn=augment,
                                          device=self.device)
        self.eval_scan = make_eval_scan(self.model, canvas=self.canvas,
                                        device=self.device)

        # lr bookkeeping for the per-epoch log (base_experiment.py:98-104)
        lr0 = float(opt_cfg["learning_rate"])
        decay = (self.cfg.get("lr_scheduler") or {}).get("decay_rate")

        def lr_at(step: int) -> float:
            if not decay or decay == 1.0:
                return lr0
            return lr0 * decay ** (step // steps_per_epoch)

        self.lr_at = lr_at

    def init_state(self, seed: int) -> TrainState:
        """Parameters drawn anew from ``seed``, as ``factory.make_scae(...,
        seed=seed)`` draws them (on the CPU, so the draws do not depend on
        the device; the model's parameters stay the same objects), a fresh
        optimizer, step 0."""
        self.model.to("cpu")
        init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        return TrainState(self.model, self.tx(self.model.parameters()),
                          step=0, seed=seed)

    def _dataset_sizes(self):
        """Optional data_loader size overrides (synthetic fallback + val
        split) so small runs can shrink the dataset from config."""
        dl = self.cfg["data_loader"]
        out = {}
        for key in ("val_size", "synthetic_train", "synthetic_test"):
            if dl.get(key) is not None:
                out[key] = int(dl[key])
        return out

    def _load_datasets(self, seed: int):
        cfg = self.cfg
        c, h, _ = cfg["model"]["image_shape"]
        return data_lib.load_datasets(
            data_dir=cfg["data_loader"].get("data_dir"), seed=seed,
            image_size=min(h, 28 if c == 1 else h), n_channels=c,
            source=cfg["data_loader"].get("source"),
            tint=cfg["data_loader"].get("tint"),
            split_seed=self.split_seed,
            **self._dataset_sizes())

    def _to_device(self, dataset) -> Dict[str, torch.Tensor]:
        return {"image": torch.from_numpy(dataset.images).to(self.device),
                "label": torch.from_numpy(
                    dataset.labels.astype(np.int64)).to(self.device)}

    def _device_eval_data(self, dataset):
        """The eval split as device tensors, cached for the most recent
        dataset object (one slot, holding a strong reference)."""
        cached = getattr(self, "_eval_data_cache", None)
        if cached is None or cached[0] is not dataset:
            self._eval_data_cache = (dataset, self._to_device(dataset))
        return self._eval_data_cache[1]

    def evaluate(self, dataset, max_batches: Optional[int] = None):
        """Mean loss terms over the eval split's first floor(n / B)
        batches (at most ``max_batches``) + host images for viz. The split
        lives on the device; one eval scan, one host sync."""
        data = self._device_eval_data(dataset)
        n_batches = len(dataset) // self.batch_size
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)
        if n_batches:
            idxs = np.arange(n_batches * self.batch_size, dtype=np.int64) \
                .reshape(n_batches, self.batch_size)
            stacked = self.eval_scan(data, idxs)
            means = {f"val_{k}": float(np.mean(v.cpu().numpy()))
                     for k, v in stacked.items()}
        else:
            means = {}
        viz = None
        if len(dataset) and n_batches:
            viz = self.center_pad({"image": torch.from_numpy(
                data_lib.to_nchw_float(dataset.images[:8]))})["image"] \
                .numpy()
        return means, viz

    def write_viz(self, step, images, max_n: int = 8):
        """The three grids from the reconstruct-alternatives forward of the
        displayed images alone; only the grids' tensors leave the device."""
        images = np.asarray(images[:max_n])
        with torch.inference_mode():
            res = self.viz_model(torch.from_numpy(images).to(self.device),
                                 deterministic=True)
            viz = viz_grid_tensors(res, n=min(max_n, images.shape[0]))
        write_reconstruction_grids(self.writer, step, viz, images,
                                   max_n=max_n)

    def run_test(self):
        """Evaluate the best (else the latest) checkpoint on the test set,
        with per-class recall and the headline accuracy over the full
        split."""
        cfg = self.cfg
        seed = cfg.get("seed", 42)
        # evaluate against the split the checkpoints were trained on
        rec = self._recorded_seed()
        if rec is not None:
            seed = rec
            print(f"[scae_tpu_torch] test: recorded training seed {seed}")
        train_ds, _, test_ds, source = self._load_datasets(seed)
        steps_per_epoch = max(len(train_ds) // self.batch_size, 1)
        self.build_steps(steps_per_epoch)
        state = self.init_state(seed)
        if self.ckpt.latest_step is None:
            raise FileNotFoundError(
                f"no checkpoint to test in {self.ckpt.directory}")
        step = self.ckpt.best_step or self.ckpt.latest_step
        state = self.ckpt.restore(state, step=step)
        metrics, _ = self.evaluate(test_ds)
        metrics = {k.replace("val_", "test_"): v for k, v in metrics.items()}
        # per-class recall and the headline test_accuracy over the FULL
        # split (remainder padded and trimmed): evaluate()'s scan floors to
        # (n // B) * B examples, so its accuracy is kept as
        # test_accuracy_scan
        if "test_accuracy" in metrics:
            metrics["test_accuracy_scan"] = metrics["test_accuracy"]
        metrics.update(self._per_class_recall(test_ds))
        self.writer.scalars(int(state.step), metrics)
        print(f"[scae_tpu_torch] test @ ckpt {step} ({source}): "
              + ", ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                          if k in ("test_loss", "test_accuracy",
                                   "test_rec_ll_loss")))
        recalls = [(k, v) for k, v in sorted(metrics.items())
                   if k.startswith("test_class")]
        if recalls:
            print("[scae_tpu_torch] per-class recall: "
                  + ", ".join(f"{k.split('_')[-2][5:]}={v:.2f}"
                              for k, v in recalls))
        return metrics

    def _per_class_recall(self, test_ds):
        """test_class<k>_recall for the better head (the max(prior,
        posterior) accuracy convention, applied per head over the full
        split), and test_accuracy over all n examples: the last batch is
        padded with zero images to B and its predictions trimmed."""
        images = self.center_pad({"image": torch.from_numpy(
            data_lib.to_nchw_float(test_ds.images))})["image"]
        labels = np.asarray(test_ds.labels)
        n, B = len(labels), self.batch_size
        n_pad = (-n) % B
        images = torch.cat([images, images.new_zeros(
            (n_pad, *images.shape[1:]))])
        pri, post = [], []
        with torch.inference_mode():
            for i in range(0, n + n_pad, B):
                res = self.model(images[i:i + B].to(self.device),
                                 deterministic=True)
                pri.append(res.prior_cls_prob.cpu().numpy())
                post.append(res.posterior_cls_prob.cpu().numpy())
        pri = np.concatenate(pri)[:n].argmax(-1)
        post = np.concatenate(post)[:n].argmax(-1)
        pred = post if np.mean(post == labels) >= np.mean(pri == labels) \
            else pri
        out = {"test_accuracy": float(np.mean(pred == labels))}
        for cls in np.unique(labels):
            m = labels == cls
            out[f"test_class{int(cls)}_recall"] = float(
                np.mean(pred[m] == cls))
        return out

    def _recorded_seed(self) -> Optional[int]:
        """The seed that trained the checkpoints in ckpt.directory
        (train_seed.json; probe_seed.json is its legacy name), or None."""
        for name in ("train_seed.json", "probe_seed.json"):
            path = os.path.join(self.ckpt.directory, name)
            if os.path.exists(path):
                with open(path) as f:
                    return int(json.load(f)["seed"])
        return None

    def run(self, max_epochs: Optional[int] = None,
            max_steps: Optional[int] = None, resume: bool = False):
        cfg = self.cfg
        seed = cfg.get("seed", 42)
        trainer_cfg = cfg["trainer"]
        max_epochs = max_epochs or trainer_cfg.get("max_epochs", 1)
        log_every = trainer_cfg.get("log_every_steps", 50)

        resuming = resume and self.ckpt.latest_step is not None
        if resuming:
            # the training seed keys the data split, so a resume must
            # reuse the recorded one
            rec = self._recorded_seed()
            if rec is not None:
                seed = rec
                print(f"[scae_tpu_torch] resume: recorded training seed "
                      f"{seed}")
        else:
            with open(os.path.join(self.ckpt.directory,
                                   "train_seed.json"), "w") as f:
                json.dump({"seed": seed, "split_seed": self.split_seed}, f)

        train_ds, val_ds, test_ds, source = self._load_datasets(seed)
        print(f"[scae_tpu_torch] dataset source: {source} "
              f"(train={len(train_ds)}, val={len(val_ds)}, "
              f"test={len(test_ds)})")

        steps_per_epoch = len(train_ds) // self.batch_size
        self.build_steps(steps_per_epoch)
        state = self.init_state(seed)
        if resuming:
            state = self.ckpt.restore(state)
            print(f"[scae_tpu_torch] resumed from step {state.step}")

        # the training split lives on the device; per chunk only a (K, B)
        # index array moves
        device_data = self._to_device(train_ds)

        global_step = state.step
        stop = False

        # Double-buffered logging, in the JAX loop's order: chunk k+1 is
        # dispatched BEFORE chunk k's metrics are read on the host.
        # `pending` holds the not yet read chunk's device metrics. On one
        # stream the read is queued behind chunk k+1's kernels, so it also
        # waits for chunk k+1: eagerly the buffer overlaps no device work
        # with the host. A chunk's images_per_sec is its images over the
        # wall time from the start of its dispatch to the start of the
        # next chunk's (eagerly, the host issues a chunk's work while the
        # device runs it), or, for a chunk with none after it before an
        # eval, to when its metrics were read.
        pending = None  # (step_after_chunk, device_metrics, k, t_start)
        # the run's training wall time: each eval period from its first
        # chunk's dispatch to its last chunk's read (evals, grids and
        # checkpoints excluded), and the images trained in it
        train_seconds, train_images = 0.0, 0

        def flush_pending(next_start=None):
            nonlocal pending
            if pending is None:
                return
            p_step, p_metrics, p_k, p_start = pending
            pending = None
            # log the chunk's last step; this read is the only host sync
            # in the hot loop
            keys = list(p_metrics)
            host = dict(zip(keys, torch.stack(
                [p_metrics[k][-1] for k in keys]).cpu().tolist()))
            end = time.time() if next_start is None else next_start
            rate = p_k * self.batch_size / max(end - p_start, 1e-9)
            self.writer.scalars(p_step,
                                {**host, "images_per_sec": rate,
                                 "learning_rate": self.lr_at(p_step)})

        # epoch and intra-epoch position derive from the restored step, so
        # a resumed run consumes exactly the indices a never-interrupted
        # run would (the permutation is seeded by the absolute epoch).
        # Chunks cross epoch boundaries: the index stream of a whole eval
        # period is assembled on the host and run in log_every-step scans.
        eval_every = trainer_cfg.get("eval_every_epochs", 1)
        if steps_per_epoch <= 0:
            raise ValueError(
                f"dataset ({len(train_ds)}) smaller than one batch "
                f"({self.batch_size}); nothing to train")
        # bound one assembled stream to ~16k steps (a few MB of indices)
        max_span = max(1, -(-16384 // steps_per_epoch))
        epoch = global_step // steps_per_epoch
        while epoch < max_epochs and not stop:
            period_end = min((epoch // eval_every + 1) * eval_every,
                             max_epochs, epoch + max_span)
            stream = np.concatenate([
                np.random.RandomState(seed + e).permutation(len(train_ds))
                [:steps_per_epoch * self.batch_size]
                .reshape(steps_per_epoch, self.batch_size)
                for e in range(epoch, period_end)], axis=0)
            stream = stream[global_step - epoch * steps_per_epoch:]
            n = stream.shape[0]
            if max_steps is not None:
                n = min(n, max(max_steps - global_step, 0))
                if n <= 0:
                    stop = True
            j = 0
            period_start = None
            while j < n:
                profiling = self.profiler.maybe_start(global_step)
                # merge a small remainder into one chunk (54 steps with
                # log_every=50 make ONE 54-step chunk, not 50 + 4)
                remaining = n - j
                k = remaining if remaining <= (log_every * 3) // 2 \
                    else log_every
                t_start = time.time()
                if period_start is None:
                    period_start = t_start
                state, metrics = self.train_scan(state, device_data,
                                                 stream[j:j + k])
                j += k
                global_step += k
                # read the previous chunk (this waits for this one too)
                flush_pending(next_start=t_start)
                pending = (global_step, metrics, k, t_start)
                if profiling:
                    # the trace must not bleed into the next chunk
                    flush_pending()
                    self.profiler.maybe_stop(global_step)
                if max_steps is not None and global_step >= max_steps:
                    stop = True
                    break
            flush_pending()  # period boundary: eval/ckpt need clean timing
            if period_start is not None:
                train_seconds += time.time() - period_start
                train_images += j * self.batch_size
            epoch = global_step // steps_per_epoch

            if (epoch % eval_every == 0 and epoch > 0) or stop \
                    or epoch >= max_epochs:
                val_metrics, viz_images = self.evaluate(
                    val_ds, max_batches=trainer_cfg.get("max_eval_batches"))
                self.writer.scalars(global_step, val_metrics)
                if viz_images is not None:
                    self.write_viz(global_step, viz_images)
                if self.monitor not in val_metrics:
                    # a typo'd monitor or an empty eval pass must not
                    # silently rank every checkpoint at a default score
                    raise KeyError(
                        f"trainer.monitor={self.monitor!r} not in eval "
                        f"metrics {sorted(val_metrics)} (empty means the "
                        "val split is smaller than one batch)")
                self.ckpt.save(
                    global_step, lambda: state,
                    metrics={self.monitor: float(
                        val_metrics[self.monitor])})
            if stop:
                break

        self.ckpt.wait()
        if train_seconds > 0:
            print(f"[scae_tpu_torch] trained {train_images} images in "
                  f"{train_seconds!r} s of training wall time (evals, grids "
                  f"and checkpoints excluded): "
                  f"{train_images / train_seconds!r} images/s")
        return state

    def close(self):
        """Close the metrics file (and TensorBoard writer) and the
        checkpoint manager."""
        self.writer.close()
        self.ckpt.close()
