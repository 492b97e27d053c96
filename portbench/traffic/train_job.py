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
others replay the graph that the window replays. Before each of them and
after the last, the program's state is copied to the host: the
parameters and the optimizer's (its step count, RMSprop's nu and the
momentum trace). Then the eval scan at the last parameters (its losses
are kept), then the rest of the first chunk. The window takes the same
state on from there.

The check follows the program one step at a time from its own state
(``follow``): each checked step k is taken by the reference from the
program's state k, with the same rows and seeds, and held to the
program's state k + 1: the loss, the gradient as the optimizer got it
(g^2 = (nu_after - decay nu_before) / (1 - decay)), the parameters'
change, and the state itself, element by element (the parameters, nu
and the trace), which the norms alone cannot hold: an update of the
wrong sign, or written to the wrong elements of a leaf, keeps every
norm. The evals are the reference's at the program's last parameters.
The start, the program's state 0, is held to the seed's weights and a
fresh optimizer exactly. A whole trajectory of the reference beside the
program's would compare two runs that rounding has pulled apart since
step 0: RMSprop's eps of 1e-2/B^2 turns a gradient's rounding into a full
step, and cuDNN's choice of algorithms, made once a process, sets the
rounding. ``compare.train`` decides.

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
        self.names = [n for n, _ in self.model.named_parameters()]
        losses, states = [], []
        with run.phase("train_captures"):
            for step in range(self.checked):
                states.append(self.snapshot())
                _, m = self.scan(self.state, self.data["train"],
                                 rows[step:step + 1])
                losses.append(m["loss"])
            states.append(self.snapshot())
        with run.phase("eval_capture"):
            ev = self.eval_scan(self.data["val"], self.val_idx)
        self.program = {"losses": torch.cat(losses).tolist(),
                        "states": states,
                        "eval_losses": ev["loss"].tolist()}
        _, m = self.scan(self.state, self.data["train"],
                         rows[self.checked:self.log_every])
        loop._finish_read(loop._start_read(m))

    def snapshot(self):
        """The program's training state on the host, by leaf name: the
        parameters, and the optimizer's step count, nu and trace."""
        opt = self.state.optimizer.state_dict()
        return {"params": {n: p.detach().to("cpu", copy=True) for n, p in
                           zip(self.names, self.model.parameters())},
                "count": opt["count"],
                "nu": dict(zip(self.names, opt["nu"])),
                "trace": dict(zip(self.names, opt["trace"]))}

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

    def initial_weights(self):
        return weights.draw_for(self.run.config["model"], self.run.seed,
                                self.run.device)

    def readings(self, record):
        """The numbers of a record of the checked steps (the program's, or
        the half-batch stand-in's): the start's largest departure from
        the seed's weights and a fresh optimizer; the losses; each step's
        gradient norms as the optimizer got them (from nu before and
        after) and the parameters' change norms, by leaf; the eval
        losses."""
        states = record["states"]
        first, w0 = states[0], self.initial_weights()
        start = max([float((p - w0[n].cpu()).abs().max())
                     for n, p in first["params"].items()]
                    + [float(t.abs().max()) for t in
                       (*first["nu"].values(), *first["trace"].values())]
                    + [abs(first["count"])])
        pairs = list(zip(states, states[1:]))
        return {
            "start": start,
            "losses": record["losses"],
            "grads": [{n: grad_norm(a["nu"][n], b["nu"][n]) for n in a["nu"]}
                      for a, b in pairs],
            "changes": [{n: float((b["params"][n].double()
                                   - a["params"][n].double()).norm())
                         for n in a["params"]} for a, b in pairs],
            "eval_losses": record["eval_losses"],
        }

    def _reference(self):
        """The reference model with the seed's weights, its RMSprop fresh,
        and its leaves' names."""
        cfg = self.run.config
        model = Model(cfg["model"]).to(self.run.device)
        model.load_state_dict(self.initial_weights())
        opt = cfg["optimizer"]
        rms = ref_train.RMSprop(
            model.parameters(), opt["learning_rate"],
            1e-2 / self.B ** 2, opt["momentum"], opt["lr_decay_per_epoch"],
            self.spe)
        return model, rms, [n for n, _ in model.named_parameters()]

    def _step(self, model, rms, step, half_batch=False):
        idx = torch.as_tensor(self.rows(0)[step], device=self.run.device)
        train = self.data["train"]
        return ref_train.train_step(
            model, rms, train["image"].index_select(0, idx),
            train["label"].index_select(0, idx), self.run.seed, step,
            self.canvas, self.max_shift, half_batch=half_batch)

    def _evals(self, model, half_batch=False):
        val, out = self.data["val"], []
        for b in range(self.n_val_batches):
            rows_b = self.val_idx[b][:self.B // 2] if half_batch \
                else self.val_idx[b]
            idx = torch.as_tensor(rows_b, device=self.run.device)
            out.append(ref_train.eval_losses(
                model, val["image"].index_select(0, idx),
                val["label"].index_select(0, idx), self.canvas))
        return out

    def follow(self, record):
        """The reference's numbers of each checked step, taken from the
        state that ``record`` holds before it, with the step's rows and
        seeds: the loss, the gradient norms and the parameters' change
        norms by leaf, and, by part of the state and by leaf, how far the
        reference moved the state (``moves``) and how far the record's
        next state lies from the reference's (``misses``); then the eval
        losses at the record's last parameters."""
        model, rms, names = self._reference()
        out = {"losses": [], "grads": [], "changes": [], "moves": [],
               "misses": []}
        states = record["states"]
        with math_mode():
            for step, (state, after) in enumerate(zip(states, states[1:])):
                load_state(model, rms, names, state)
                values, grads = self._step(model, rms, step)
                ref = state_of(model, rms, names)
                out["losses"].append(values["loss"])
                out["grads"].append({n: float(g.double().norm())
                                     for n, g in zip(names, grads)})
                moves = {k: distances(ref[k], state[k]) for k in PARTS}
                out["changes"].append(moves["params"])
                out["moves"].append(moves)
                out["misses"].append({k: distances(after[k], ref[k])
                                      for k in PARTS})
            load_state(model, rms, names, states[-1])
            out["eval_losses"] = self._evals(model)
        return out

    def half_batch_record(self):
        """A record as set-up keeps the program's, made by the reference in
        the program's place with each step, and each eval, on the first
        half of its batch: a fault the check must catch."""
        model, rms, names = self._reference()
        losses, states = [], []
        with math_mode():
            for step in range(self.checked):
                states.append(state_of(model, rms, names))
                values, _ = self._step(model, rms, step, half_batch=True)
                losses.append(values["loss"])
            states.append(state_of(model, rms, names))
            evals = self._evals(model, half_batch=True)
        return {"losses": losses, "states": states, "eval_losses": evals}

    def check(self):
        return compare.train(self.readings(self.program),
                             self.follow(self.program), self.run.limits)


PARTS = ("params", "nu", "trace")    # a state's tensors, by leaf


def distances(a, b):
    """{leaf: ||a - b||} of two {leaf: tensor} maps, in float64."""
    return {n: float((a[n].double() - b[n].double()).norm()) for n in a}


def state_of(model, rms, names):
    """The reference's training state on the host, as ``Job.snapshot``
    keeps the program's."""
    def host(ts):
        return {n: t.detach().to("cpu", copy=True) for n, t in zip(names, ts)}
    return {"params": host(model.parameters()), "count": rms.count,
            "nu": host(rms.nu), "trace": host(rms.trace)}


@torch.no_grad()
def load_state(model, rms, names, state):
    """The reference model and RMSprop put in the training state
    ``state`` (as ``Job.snapshot`` keeps it)."""
    for n, p in zip(names, model.parameters()):
        p.copy_(state["params"][n])
    dev = rms.params[0].device
    rms.nu = [state["nu"][n].to(dev, copy=True) for n in names]
    rms.trace = [state["trace"][n].to(dev, copy=True) for n in names]
    rms.count = state["count"]
