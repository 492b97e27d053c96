"""Kind ``train_job``: a training job as the port's Trainer runs one.

The training split lives on the device (uint8, the dataset's layout); each
epoch is a permutation drawn from the seed, cut to whole batches. The job
drives ``scae_tpu_torch.parallel.train_step.make_train_scan`` in chunks of
``log_every_steps`` rows (a remainder of at most 1.5 chunks merged into
one, as ``Trainer.run`` merges it), reads each chunk's last-step losses
after the next chunk's dispatch (``train.loop._start_read`` /
``_finish_read``, as ``Trainer.run`` reads them), and after each epoch
runs ``make_eval_scan`` over the validation split's whole batches and
reads the means on the host.

Set-up builds one training state (the model with the run's weights, the
optimizer), and drives it from the seed through the job's first steps
with the window's own scan and data, one scan call a step for
``checked_steps`` steps: the first runs eagerly (the scan's warm-up), the
others replay the graph that the window replays. RMSprop's nu after each
of the first two steps and the parameters after the last are kept, so
the gradients of the eager step and of the first replay are both read
as the optimizer got them: g^2 = (nu_after - decay nu_before) /
(1 - decay). Then the eval scan at those parameters (its losses are
kept), then the rest of the first chunk. The window takes the same state
on from there.
The reference then follows the checked steps from the same weights and
rows (``reference/train.py``), and ``compare.train`` decides.

Parameters: batch_size, log_every_steps, checked_steps.
"""

import math
import time

import numpy as np
import torch

from portbench import compare, data as data_lib, trace as trace_lib, weights
from portbench.reference import math_mode
from portbench.reference import train as ref_train
from portbench.reference.model import Model

RMSPROP_DECAY = 0.99    # make_optimizer's: nu <- 0.99 nu + 0.01 g^2


def grad_norm(nu_before, nu_after):
    """The norm of the gradient that RMSprop took between two of its nu
    states."""
    sq = (nu_after.double() - RMSPROP_DECAY * nu_before.double()) \
        / (1.0 - RMSPROP_DECAY)
    return math.sqrt(max(float(sq.sum()), 0.0))


class Job:
    def __init__(self, run):
        self.run = run
        self.B = run.params["batch_size"]
        self.log_every = run.params["log_every_steps"]
        self.checked = run.params["checked_steps"]
        d = run.config["data"]
        self.canvas, self.max_shift = d["canvas"], d["max_shift"]
        self.spe = d["train"] // self.B
        self.n_val_batches = d["val"] // self.B
        self.val_idx = np.arange(self.n_val_batches * self.B).reshape(
            self.n_val_batches, self.B)

    # ------------------------------------------------------------ set-up

    def setup(self):
        from scae_tpu_torch import factory
        from scae_tpu_torch.optim import make_optimizer
        from scae_tpu_torch.parallel import train_step
        from scae_tpu_torch.train import loop

        run, cfg, dev = self.run, self.run.config, self.run.device
        self.loop = loop
        with run.phase("model"):
            self.model = factory.make_scae(cfg["model"], device=dev)
            self.model.load_state_dict(weights.draw_for(cfg["model"],
                                                        run.seed, dev))
        with run.phase("data"):
            self.data = data_lib.dataset(cfg["data"], run.seed, dev)
        opt = cfg["optimizer"]
        optimizer = make_optimizer(
            self.model.parameters(), name=opt["name"],
            learning_rate=opt["learning_rate"], batch_size=self.B,
            momentum=opt["momentum"],
            lr_decay_rate=opt["lr_decay_per_epoch"], decay_steps=self.spe)
        self.state = train_step.TrainState(self.model, optimizer, step=0,
                                           seed=run.seed)
        augment = loop.make_augment_fn(self.canvas, self.max_shift)
        self.scan = train_step.make_train_scan(augment_fn=augment,
                                               device=dev)
        self.eval_scan = train_step.make_eval_scan(
            self.model, canvas=self.canvas, device=dev)
        if run.fault is not None:
            run.fault(self)

        rows = self.rows(0)
        losses, nus = [], []
        with run.phase("train_captures"):
            for step in range(self.checked):
                _, m = self.scan(self.state, self.data["train"],
                                 rows[step:step + 1])
                losses.append(m["loss"])
                if step < 2:
                    nus.append([t.detach().clone() for t in optimizer.nu])
            params = [p.detach().clone() for p in self.model.parameters()]
        with run.phase("eval_capture"):
            ev = self.eval_scan(self.data["val"], self.val_idx)
        self.program = {
            "losses": torch.cat(losses).tolist(),
            "nus": nus, "params": params,
            "names": [n for n, _ in self.model.named_parameters()],
            "eval_losses": ev["loss"].tolist(),
        }
        _, m = self.scan(self.state, self.data["train"],
                         rows[self.checked:self.log_every])
        loop._finish_read(loop._start_read(m))

    def rows(self, epoch):
        return data_lib.epoch_rows(self.run.seed, epoch,
                                   self.run.config["data"]["train"], self.B)

    # ------------------------------------------------------------ window

    def _chunks(self, stop=lambda: False, epochs=None, traced=False):
        """Run the job on from its state until ``stop()`` says so at a
        chunk boundary, or until ``epochs`` epochs have ended with their
        eval; returns (steps, eval batches, failed steps)."""
        loop, run = self.loop, self.run
        steps = evals = failed = ended = 0
        pending = None
        while not stop() and ended != epochs:
            epoch, pos = divmod(self.state.step, self.spe)
            stream = self.rows(epoch)[pos:]
            n, j = len(stream), 0
            while j < n and not stop():
                k = n - j if n - j <= (self.log_every * 3) // 2 \
                    else self.log_every
                with trace_lib.span(torch, "scan", traced):
                    _, metrics = self.scan(self.state, self.data["train"],
                                           stream[j:j + k])
                read = loop._start_read(metrics)
                j += k
                steps += k
                if pending is not None:
                    with trace_lib.span(torch, "read", traced):
                        failed += self._read(pending)
                pending = (read, k)
            if pending is not None:
                with trace_lib.span(torch, "read", traced):
                    failed += self._read(pending)
                pending = None
            if j == n and (epochs is not None or not stop()):
                with trace_lib.span(torch, "eval", traced):
                    ev = self.eval_scan(self.data["val"], self.val_idx)
                    # the means on the host, as Trainer.evaluate reads them
                    self.eval_means = {k: float(np.mean(v.cpu().numpy()))
                                       for k, v in ev.items()}
                evals += self.n_val_batches
                ended += 1
        return steps, evals, failed

    def _read(self, pending):
        read, k = pending
        host = self.loop._finish_read(read)
        return 0 if math.isfinite(host["loss"]) else k

    def window(self, seconds):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        steps, evals, failed = self._chunks(
            lambda: time.perf_counter() >= deadline)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        wall = time.perf_counter() - t0
        self.run.stats.update(
            attempted=steps, failed=failed, window_s=wall, steps=steps,
            images=steps * self.B, eval_images=evals * self.B,
            batch=self.B)

    def profile(self):
        """After the window: the job on to the next epoch's start, then one
        whole epoch and its eval in the profiled sub-window."""
        self._chunks(epochs=1)
        start = self.state.step
        self.run.trace = trace_lib.profile(torch, lambda: self._chunks(
            epochs=1, traced=True))
        self.run.counters["k23_hits"] = self._hits(start)

    @torch.no_grad()
    def _hits(self, step):
        """Pairs whose taps touch the template in step ``step``'s batch
        (its translation drawn as the step draws it), at the parameters
        as they stand."""
        from portbench.counts import roofline

        idx = torch.as_tensor(self.rows(step // self.spe)[step % self.spe],
                              device=self.run.device)
        raw = self.data["train"]["image"].index_select(0, idx)
        images = ref_train.pad_to(ref_train.decode(raw), self.canvas)
        gen = torch.Generator(device=self.run.device).manual_seed(
            ref_train.fold_in(self.run.seed, step, 7))
        images = ref_train.translate(images, gen, self.max_shift)
        pose = self.model(images, deterministic=True).part_pose
        tg = self.run.config["model"].get(
            "pcae_template_generator_params") or {}
        return roofline.hits(pose.float(), tuple(tg.get("template_size",
                                                       (11, 11))),
                             tuple(self.run.config["model"]["image_shape"][1:]))

    # ------------------------------------------------------------- check

    def release(self):
        for name in ("state", "scan", "eval_scan", "model"):
            setattr(self, name, None)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self):
        """The program's numbers from what set-up kept: the losses, the
        first two steps' gradient norms (from RMSprop's nu before and
        after each), the change norms after the checked steps, the eval
        losses."""
        p = self.program
        w0 = self.initial_weights()
        nus = [[torch.zeros_like(t) for t in p["nus"][0]], *p["nus"]]
        return {
            "losses": p["losses"],
            "grad_norms": [{n: grad_norm(before, after)
                            for n, before, after in zip(p["names"], *pair)}
                           for pair in zip(nus, nus[1:])],
            "change_norms": {n: float((q - w0[n]).double().norm())
                             for n, q in zip(p["names"], p["params"])},
            "eval_losses": p["eval_losses"],
        }

    def initial_weights(self):
        return weights.draw_for(self.run.config["model"], self.run.seed,
                                self.run.device)

    def reference_readings(self, half_batch=False, tf32=False):
        """The reference's numbers over the same weights, rows and seeds
        (``half_batch``, ``tf32``: the fault and the control that the
        comparison must catch, the reference put in the program's place;
        the half batch holds in the evals too)."""
        run, cfg = self.run, self.run.config
        model = Model(cfg["model"]).to(run.device)
        w0 = self.initial_weights()
        model.load_state_dict(w0)
        names = [n for n, _ in model.named_parameters()]
        opt = cfg["optimizer"]
        rms = ref_train.RMSprop(
            model.parameters(), opt["learning_rate"],
            1e-2 / self.B ** 2, opt["momentum"], opt["lr_decay_per_epoch"],
            self.spe)
        rows = self.rows(0)
        train = self.data["train"]
        losses, grad_norms = [], []
        with math_mode(tf32):
            for step in range(self.checked):
                idx = torch.as_tensor(rows[step], device=run.device)
                values, grads = ref_train.train_step(
                    model, rms, train["image"].index_select(0, idx),
                    train["label"].index_select(0, idx), run.seed, step,
                    self.canvas, self.max_shift, half_batch=half_batch)
                losses.append(values["loss"])
                if step < 2:
                    grad_norms.append({n: float(g.double().norm())
                                       for n, g in zip(names, grads)})
            change = {n: float((p.detach() - w0[n]).double().norm())
                      for n, p in zip(names, model.parameters())}
            val = self.data["val"]
            eval_losses = []
            for b in range(self.n_val_batches):
                rows_b = self.val_idx[b][:self.B // 2] if half_batch \
                    else self.val_idx[b]
                idx = torch.as_tensor(rows_b, device=run.device)
                eval_losses.append(ref_train.eval_losses(
                    model, val["image"].index_select(0, idx),
                    val["label"].index_select(0, idx), self.canvas))
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change, "eval_losses": eval_losses}

    def check(self):
        return compare.train(self.program_readings(),
                             self.reference_readings(), self.run.limits)

