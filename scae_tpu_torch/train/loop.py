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

And the JAX loop's four options around a run:

  * ``init_from`` (``_warm_start_params``): a new run starts from another
    run's parameters (its best checkpoint by this run's monitor where the
    source recorded it, else its latest; ``init_from_step`` pins one),
    with a fresh optimizer and step, at every fresh init;
  * ``trainer.template_init=patches`` (``_patch_template_init``): the
    template logits start as random content crops of the training images;
  * ``trainer.seed_probe`` (``probe_seeds``): n candidate seeds trained
    briefly, the best by validation reconstruction NLL continued;
  * ``trainer.head_refit`` (``refit_head``): at the end, the posterior
    head refit on the best checkpoint's frozen features by multinomial
    logistic regression (``train/logreg.py``, sklearn's model without
    sklearn) and saved as a new checkpoint.

With ``trainer.mesh`` under a process group
(``parallel.mesh.maybe_initialize_distributed``, as ``train/cli.py`` calls
it) the Trainer does what the JAX loop does on its mesh: the state is
replicated on every process (a ``n_model`` above 1 leaves the capsule
banks whole, as JAX's replicated state does; ``parallel.train_step.
shard_state`` splits them), each global batch is split over the data
ranks, and the steps compute the global batch's loss, gradients and
metrics. Its side effects happen on process 0 only: the metrics records,
the image grids, the prints, ``train_seed.json`` and the checkpoints,
which process 0 writes in the single-process format while the others
wait at a barrier; every process restores them. ``mode=test`` leaves out
the per-class recall on more than one process, as JAX's does. The seed
probe and the head refit on a mesh of more than one device are refused
(``NotImplementedError``).
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
from scae_tpu_torch.parallel import mesh as mesh_lib
from scae_tpu_torch.parallel import train_step
from scae_tpu_torch.parallel.train_step import (
    TrainState,
    make_eval_scan,
    make_train_scan,
)
from scae_tpu_torch.train import data as data_lib
from scae_tpu_torch.train import logreg
from scae_tpu_torch.train.checkpoint import (CheckpointManager,
                                             NullCheckpointManager,
                                             load_payload, state_payload)
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


def _start_read(metrics):
    """Start a chunk's last-step metrics on their way to the host without
    waiting: (names, host values, event). On the card the values are a
    copy into pinned memory behind a recorded CUDA event; on the CPU they
    are the metrics themselves and the event is None."""
    names = list(metrics)
    last = torch.stack([metrics[k][-1] for k in names])
    if last.device.type != "cuda":
        return names, last, None
    host = torch.empty(last.shape, dtype=last.dtype, pin_memory=True)
    host.copy_(last, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return names, host, event


def _finish_read(read) -> Dict[str, float]:
    """The metrics of ``_start_read``, as host floats, once its event has
    completed."""
    names, host, event = read
    if event is not None:
        event.synchronize()
    return dict(zip(names, host.tolist()))


def _say(message: str):
    """Print ``message`` on process 0 only."""
    if mesh_lib.is_process_zero():
        print(message)


def _refuse_deferred(cfg: Dict):
    """ValueError for a ``trainer.template_init`` the port does not
    know."""
    trainer_cfg = cfg.get("trainer") or {}
    if trainer_cfg.get("template_init") not in (None, "patches"):
        raise ValueError(f"trainer.template_init="
                         f"{trainer_cfg['template_init']!r}: expected null "
                         "or 'patches'")


def _refuse_on_mesh(cfg: Dict, mesh: mesh_lib.Mesh):
    """NotImplementedError for the features the port does not run on a
    mesh of more than one device yet (ROADMAP, queue 1), rather than
    ignore them; ValueError where the data ranks do not divide the
    batch."""
    trainer_cfg = cfg.get("trainer") or {}
    if mesh.size > 1:
        for key, on in (
                ("trainer.seed_probe",
                 int((trainer_cfg.get("seed_probe") or {}).get("n", 0)
                     or 0) > 0),
                ("trainer.head_refit", bool(trainer_cfg.get("head_refit")))):
            if on:
                raise NotImplementedError(
                    f"not ported to scae_tpu_torch yet: {key} on a mesh of "
                    f"more than one device ({mesh.n_data}x{mesh.n_model}; "
                    "ROADMAP, queue 1)")
    batch = cfg["data_loader"]["batch_size"]
    if batch % mesh.n_data:
        raise ValueError(f"data_loader.batch_size={batch} does not split "
                         f"over the mesh's {mesh.n_data} data ranks")


class Trainer:
    def __init__(self, cfg: Dict, device=None):
        _refuse_deferred(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        mesh_cfg = (cfg.get("trainer") or {}).get("mesh") or {}
        mesh = mesh_lib.make_mesh(n_data=mesh_cfg.get("n_data"),
                                  n_model=mesh_cfg.get("n_model", 1))
        _refuse_on_mesh(cfg, mesh)
        # None without a process group: the single-process path
        self.mesh = mesh_lib.live(mesh)
        self.main = mesh_lib.is_process_zero()
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
        # the metrics records are process 0's
        self.writer = MetricsWriter(self.log_dir) if self.main else None
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
                                          device=self.device, mesh=self.mesh)
        self.eval_scan = make_eval_scan(self.model, canvas=self.canvas,
                                        device=self.device, mesh=self.mesh)

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
        the device; the model's parameters stay the same objects), or with
        ``init_from`` the source run's (``_warm_start_params``); a fresh
        optimizer, step 0."""
        self.model.to("cpu")
        init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        warm = self._warm_start_params()
        if warm is not None:
            self.model.load_state_dict(warm)
        return TrainState(self.model, self.tx(self.model.parameters()),
                          step=0, seed=seed)

    def _patch_template_init(self, train_ds, seed: int):
        """``trainer.template_init=patches``: replace the template logits
        with M random content crops of the training images, drawn from
        ``np.random.RandomState(seed)`` as the JAX loop draws them (an
        image, then a row, then a column; a crop of mean 0.05 or less is
        redrawn unless 50 M draws have passed), clipped to [0.01, 0.99]
        and mapped through the inverse of the template nonlinearity where
        it is the sigmoid (the logit), taken as they are otherwise."""
        generator = self.model.template_generator
        logits = generator.template_logits       # (1, M, C, Ht, Wt)
        _, M, C, Ht, Wt = logits.shape
        imgs = data_lib.to_nchw_float(train_ds.images)   # (N, C', H, W)
        N, Ci, H, W = imgs.shape
        if Ci != C or H < Ht or W < Wt:
            raise ValueError(
                f"template_init=patches: dataset images {imgs.shape[1:]} "
                f"cannot provide ({C},{Ht},{Wt}) template crops")
        rng = np.random.RandomState(seed)
        crops, tries = [], 0
        while len(crops) < M:
            i = rng.randint(N)
            y, x = rng.randint(H - Ht + 1), rng.randint(W - Wt + 1)
            c = imgs[i, :, y:y + Ht, x:x + Wt]
            if c.mean() > 0.05 or tries > 50 * M:
                crops.append(c)
            tries += 1
        p = np.clip(np.stack(crops)[None], 0.01, 0.99).astype(np.float32)
        nonlin = generator.template_nonlin_name
        patched = np.log(p / (1.0 - p)) if nonlin == "sigmoid" else p
        with torch.no_grad():
            logits.copy_(torch.from_numpy(patched))
        _say(f"[scae_tpu_torch] template_init=patches: {M} crops from "
              f"{N} train images (nonlin={nonlin})")

    def _maybe_patch_templates(self, state, train_ds, seed: int):
        """``_patch_template_init`` on ``state``'s model where the config
        asks for it, unless ``init_from`` is set; ``state``."""
        if (self.cfg.get("trainer") or {}).get("template_init") == \
                "patches" and not self.cfg.get("init_from"):
            self._patch_template_init(train_ds, seed)
        return state

    def _warm_start_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The parameters of ``init_from=<checkpoint_dir>`` (a
        ``state_dict`` of CPU tensors), or None: the source's checkpoint
        ``init_from_step``, else its best by this run's monitor where the
        source recorded that metric, else its latest. Read once and cached.
        Raises FileNotFoundError where the source has no checkpoint and
        ValueError where its names, shapes or dtypes differ from this
        model's."""
        path = self.cfg.get("init_from")
        if not path:
            return None
        cached = getattr(self, "_warm_params", None)
        if cached is None:
            src = CheckpointManager(path, monitor=self.monitor,
                                    mode=self.monitor_mode)
            step = self.cfg.get("init_from_step")
            if step is None:
                # a source trained under another monitor ranks every
                # checkpoint equal-worst: take its latest then
                best = src.best_step
                if best is not None and self.monitor in (
                        src.metrics(best) or {}):
                    step = best
                else:
                    step = src.latest_step
            if step is None:
                raise FileNotFoundError(
                    f"init_from={path!r} contains no checkpoints")
            cached = src.restore_params(step=step)
            src.close()
            ref = {k: (tuple(v.shape), v.dtype)
                   for k, v in self.model.state_dict().items()}
            got = {k: (tuple(v.shape), v.dtype) for k, v in cached.items()}
            if ref != got:
                raise ValueError(
                    f"init_from={path!r} step {step}: checkpoint "
                    "parameters do not match this model architecture "
                    "(names / shapes / dtypes differ)")
            _say(f"[scae_tpu_torch] warm start: params from {path} "
                  f"step {step}")
            self._warm_params = cached
        return cached

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
            _say(f"[scae_tpu_torch] test: recorded training seed {seed}")
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
        if mesh_lib.process_count() == 1:
            if "test_accuracy" in metrics:
                metrics["test_accuracy_scan"] = metrics["test_accuracy"]
            metrics.update(self._per_class_recall(test_ds))
        if self.main:
            self.writer.scalars(int(state.step), metrics)
        _say(f"[scae_tpu_torch] test @ ckpt {step} ({source}): "
              + ", ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                          if k in ("test_loss", "test_accuracy",
                                   "test_rec_ll_loss")))
        recalls = [(k, v) for k, v in sorted(metrics.items())
                   if k.startswith("test_class")]
        if recalls:
            _say("[scae_tpu_torch] per-class recall: "
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

    def _epoch_stream(self, seed: int, n: int, epochs, steps_per_epoch):
        """The (steps, B) index rows of ``epochs``: each epoch's
        ``RandomState(seed + epoch)`` permutation of the ``n`` training
        examples, cut to whole batches."""
        return np.concatenate([
            np.random.RandomState(seed + e).permutation(n)
            [:steps_per_epoch * self.batch_size]
            .reshape(steps_per_epoch, self.batch_size)
            for e in epochs], axis=0)

    def probe_seeds(self, base_seed: int, n: int, probe_epochs: int):
        """Train the n candidate seeds ``base_seed`` .. ``base_seed + n - 1``
        for ``probe_epochs`` each and return (seed, state) of the one with
        the lowest validation reconstruction NLL (``val_rec_ll_loss``; a
        NaN scores as inf; ties go to the lower seed). The winner's state is
        continued by ``run``, not replayed: its probe epochs count toward
        the schedule. Each candidate trains on its own seed's split unless
        ``data_loader.split_seed`` is set, in spans of at most ~16k steps
        as the main loop's.

        The candidates share the Trainer's model: each is a fresh state
        (fresh parameters and optimizer; on the card its scans capture
        their graphs anew), and the leader's state is kept on the host
        (``state_payload``) while later candidates train, then copied back
        if it is not the last one trained."""
        cfg = self.cfg
        results = []
        leader = None          # the leader's payload, unless it is current
        built = False
        for s in range(base_seed, base_seed + n):
            train_ds, val_ds, _, _ = self._load_datasets(s)
            spe = len(train_ds) // self.batch_size
            if spe <= 0:
                raise ValueError("dataset smaller than one batch")
            if not built:
                self.build_steps(spe)
                built = True
            captured = dict(train_step.captures)
            state = self.init_state(s)
            state = self._maybe_patch_templates(state, train_ds, s)
            data = self._to_device(train_ds)
            max_span = max(1, -(-16384 // spe))
            e = 0
            while e < probe_epochs:
                span_end = min(probe_epochs, e + max_span)
                stream = self._epoch_stream(s, len(train_ds),
                                            range(e, span_end), spe)
                state, _ = self.train_scan(state, data, stream)
                e = span_end
            metrics, _ = self.evaluate(
                val_ds, max_batches=cfg["trainer"].get("max_eval_batches"))
            score = float(metrics.get("val_rec_ll_loss",
                                      metrics.get("val_loss",
                                                  float("inf"))))
            # a diverged probe (NaN) must lose: NaN compares False with
            # everything, so min() could otherwise return it
            if not np.isfinite(score):
                score = float("inf")
            results.append((score, s))
            if (score, s) == min(results):
                # the next candidate redraws the model: keep the leader on
                # the host, unless no candidate comes after it
                leader = state_payload(state) if s < base_seed + n - 1 \
                    else None
            graphs = {k: v - captured[k]
                      for k, v in train_step.captures.items()}
            _say(f"[scae_tpu_torch] seed probe {s}: val_rec_ll={score:.2f} "
                  f"({probe_epochs} epochs; CUDA graphs captured: "
                  f"{graphs['train']} train, {graphs['eval']} eval)")
        best = min(results)[1]
        _say(f"[scae_tpu_torch] seed probe winner: {best} "
              f"(of {[s for _, s in results]})")
        if leader is not None:
            state = load_payload(
                TrainState(self.model, self.tx(self.model.parameters())),
                leader)
        return best, state

    def run(self, max_epochs: Optional[int] = None,
            max_steps: Optional[int] = None, resume: bool = False):
        cfg = self.cfg
        seed = cfg.get("seed", 42)
        trainer_cfg = cfg["trainer"]
        max_epochs = max_epochs or trainer_cfg.get("max_epochs", 1)
        log_every = trainer_cfg.get("log_every_steps", 50)

        probe = trainer_cfg.get("seed_probe") or {}
        n_probe = int(probe.get("n", 0) or 0)
        resuming = resume and self.ckpt.latest_step is not None
        probe_state = None
        if resuming:
            # the training seed keys the data split, so a resume must
            # reuse the recorded one
            rec = self._recorded_seed()
            if rec is not None:
                seed = rec
                _say(f"[scae_tpu_torch] resume: recorded training seed "
                      f"{seed}")
            elif n_probe > 0:
                raise FileNotFoundError(
                    "resume with trainer.seed_probe enabled, but the "
                    "checkpoint dir records no training seed: the probe "
                    "winner's data split cannot be recovered")
        else:
            if n_probe > 0:
                seed, probe_state = self.probe_seeds(
                    seed, n_probe, int(probe.get("epochs", 200)))
            if self.main:
                with open(os.path.join(self.ckpt.directory,
                                       "train_seed.json"), "w") as f:
                    json.dump({"seed": seed, "split_seed": self.split_seed},
                              f)

        train_ds, val_ds, test_ds, source = self._load_datasets(seed)
        _say(f"[scae_tpu_torch] dataset source: {source} "
              f"(train={len(train_ds)}, val={len(val_ds)}, "
              f"test={len(test_ds)})")

        steps_per_epoch = len(train_ds) // self.batch_size
        self.build_steps(steps_per_epoch)
        if probe_state is not None:
            # the winner's probe training continues (the same datasets and
            # index stream as a run from its init would see)
            state = probe_state
            _say(f"[scae_tpu_torch] continuing probe winner from step "
                  f"{state.step}")
        else:
            state = self.init_state(seed)
            state = self._maybe_patch_templates(state, train_ds, seed)
        if resuming:
            state = self.ckpt.restore(state)
            _say(f"[scae_tpu_torch] resumed from step {state.step}")

        # the training split lives on the device; per chunk only a (K, B)
        # index array moves
        device_data = self._to_device(train_ds)

        global_step = state.step
        stop = False

        # Double-buffered logging, in the JAX loop's order: chunk k+1 is
        # dispatched BEFORE chunk k's metrics are read on the host. Right
        # after its dispatch, a chunk's last-step metrics start on their
        # way to pinned host memory behind an event (``_start_read``); the
        # read of chunk k, after chunk k+1's dispatch, waits for chunk k's
        # event only, so the host issues chunk k+1 while the device runs
        # chunk k. A chunk's images_per_sec is its images over the wall
        # time from the start of its dispatch to the start of the next
        # chunk's, or, for a chunk with none after it before an eval, to
        # when its metrics were read.
        pending = None  # (step_after_chunk, read, k, t_start)
        # the run's training wall time: each eval period from its first
        # chunk's dispatch to its last chunk's read (evals, grids and
        # checkpoints excluded), and the images trained in it
        train_seconds, train_images = 0.0, 0

        def flush_pending(next_start=None):
            nonlocal pending
            if pending is None:
                return
            p_step, p_read, p_k, p_start = pending
            pending = None
            # log the chunk's last step; this wait is the only host sync
            # in the hot loop
            host = _finish_read(p_read)
            end = time.time() if next_start is None else next_start
            rate = p_k * self.batch_size / max(end - p_start, 1e-9)
            if self.main:
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
            stream = self._epoch_stream(seed, len(train_ds),
                                        range(epoch, period_end),
                                        steps_per_epoch)
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
                read = _start_read(metrics)
                j += k
                global_step += k
                # read the previous chunk (waits for that chunk only)
                flush_pending(next_start=t_start)
                pending = (global_step, read, k, t_start)
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
                if self.main:
                    # the records and grids are process 0's
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
                if self.main:
                    # the state is replicated: process 0 writes it whole,
                    # the others wait until it is there
                    self.ckpt.save(
                        global_step, lambda: state,
                        metrics={self.monitor: float(
                            val_metrics[self.monitor])})
                mesh_lib.barrier()
            if stop:
                break

        self.ckpt.wait()
        if train_seconds > 0:
            _say(f"[scae_tpu_torch] trained {train_images} images in "
                  f"{train_seconds!r} s of training wall time (evals, grids "
                  f"and checkpoints excluded): "
                  f"{train_images / train_seconds!r} images/s")
        if trainer_cfg.get("head_refit"):
            self.refit_head(train_ds, val_ds)
        return state

    def _posterior_features(self, dataset):
        """(features (n, O) float64, labels (n,)): each example's
        ``posterior_mixing_prob`` summed over its parts, from the
        deterministic forward of the model as it stands, in batches of B
        (the last padded with zero images, its padding dropped)."""
        h = self.cfg["model"]["image_shape"][1]
        images = data_lib.pad_to_canvas(torch.from_numpy(
            data_lib.to_nchw_float(dataset.images)), h)
        n, B = len(images), self.batch_size
        images = torch.cat([images, images.new_zeros(
            ((-n) % B, *images.shape[1:]))])
        feats = []
        with torch.inference_mode():
            for i in range(0, len(images), B):
                res = self.model(images[i:i + B].to(self.device),
                                 deterministic=True)
                feats.append(res.obj.posterior_mixing_prob.sum(-1).cpu())
        return (torch.cat(feats)[:n].numpy().astype(np.float64),
                np.asarray(dataset.labels))

    def refit_head(self, train_ds, val_ds,
                   c_grid=(0.1, 1.0, 10.0, 100.0)):
        """End-of-run posterior-head refit on the frozen trunk
        (``trainer.head_refit=true``), as the JAX loop's: the best retained
        checkpoint (else the latest) is restored; a multinomial logistic
        regression (``logreg.fit``, sklearn's ``LogisticRegression``
        model) of the labels on its ``_posterior_features`` is fitted on
        the training split for each C of ``c_grid`` and the C of the
        highest validation accuracy kept (the first of ties); its
        coefficients and intercepts become the posterior classifier; the
        model is evaluated on the validation split and saved at
        ``max(best, latest) + 1`` with the monitor's metric. Returns the
        validation metrics, or None where there is no checkpoint or no
        posterior classifier. The Trainer's model is left as it was."""
        best = self.ckpt.best_step or self.ckpt.latest_step
        if best is None:
            _say("[scae_tpu_torch] head_refit: no retained checkpoint "
                  "(trainer.save_top_k=0?) — skipped")
            return None
        if "posterior_classifier.weight" not in \
                self.ckpt.restore_params(step=best):
            _say("[scae_tpu_torch] head_refit: model has no posterior "
                  "classifier — skipped")
            return None
        # the caller's parameters (the run's last state) come back after
        # the refit, as JAX's refit works on a copy and leaves them alone;
        # both loads copy in place, so the scans' graphs stay valid
        final = {k: v.clone() for k, v in self.model.state_dict().items()}
        try:
            state = self.ckpt.restore(
                TrainState(self.model, self.tx(self.model.parameters())),
                step=best)
            t0 = time.perf_counter()
            Xtr, ytr = self._posterior_features(train_ds)
            Xval, yval = self._posterior_features(val_ds)
            seconds = [time.perf_counter() - t0]
            best_fit = None
            for C in c_grid:
                t0 = time.perf_counter()
                fitted = logreg.fit(Xtr, ytr, C)
                seconds.append(time.perf_counter() - t0)
                acc = float(np.mean(fitted.predict(Xval) == yval))
                if best_fit is None or acc > best_fit[1]:
                    best_fit = (fitted, acc, C)
            fitted, probe_val, c_star = best_fit
            _say(f"[scae_tpu_torch] head_refit: features of {len(Xtr)} + "
                  f"{len(Xval)} examples in {seconds[0]!r} s; fits of "
                  f"C={list(c_grid)} in {seconds[1:]!r} s")
            head = self.model.posterior_classifier
            if fitted.coef.shape != tuple(head.weight.shape):
                raise ValueError(f"head_refit: probe shape "
                                 f"{fitted.coef.shape} != head "
                                 f"{tuple(head.weight.shape)}")
            with torch.no_grad():
                head.weight.copy_(torch.from_numpy(fitted.coef))
                head.bias.copy_(torch.from_numpy(fitted.intercept))
            vm, _ = self.evaluate(val_ds)
            if self.monitor not in vm:
                raise KeyError(f"head_refit: trainer.monitor="
                               f"{self.monitor!r} not in eval metrics "
                               f"{sorted(vm)}")
            # past the LATEST step: a save at or before it is refused, and
            # the best checkpoint is usually not the last one written
            refit_step = max(int(best), int(self.ckpt.latest_step or 0)) + 1
            self.writer.scalars(refit_step, vm)
            saved = self.ckpt.save(
                refit_step, state,
                metrics={self.monitor: float(vm[self.monitor])})
            if not saved:
                raise RuntimeError(
                    f"head_refit: checkpoint manager refused save at step "
                    f"{refit_step} (latest={self.ckpt.latest_step})")
            _say(f"[scae_tpu_torch] head_refit: C*={c_star} probe val "
                  f"{probe_val:.4f}; refit ckpt {refit_step} "
                  f"{self.monitor}={vm[self.monitor]:.4f} "
                  f"(best was ckpt {best})")
        finally:
            self.model.load_state_dict(final)
        return vm

    def close(self):
        """Close the metrics file (and TensorBoard writer) and the
        checkpoint manager."""
        if self.writer is not None:
            self.writer.close()
        self.ckpt.close()
