"""Import a trained scae_tpu run into a checkpoint of the PyTorch port.

    python tools/import_jax_checkpoint.py RUN_DIR --out OUT_DIR \
        [--step N] -- <the run's config overrides>

RUN_DIR is a run's checkpoint directory as scae_tpu's training CLI writes
it (Orbax step directories and ``train_seed.json``). The script reads one
step with ``scae_tpu.train.checkpoint.CheckpointManager``, by default the
best by the config's monitor, else the latest, and writes it as one
checkpoint of ``scae_tpu_torch/train/checkpoint.py``'s format,
``OUT_DIR/<step>/checkpoint.pt`` and ``metrics.json``, through the port's
own ``CheckpointManager.save``, with the run's ``train_seed.json`` beside
it. The port's ``init_from``, ``mode=test``, ``tools.export_model`` and
``examples.infer_demo`` then read it.

This is the one file of the port that imports Orbax and ``scae_tpu``,
which ``scae_tpu_torch`` may not, so it lives outside the package and
runs where JAX is installed; the CUDA machine has no JAX: import there
and copy OUT_DIR over.

What is carried over:

  * the parameters, through ``scae_tpu_torch/utils/from_flax.py``
    (``flax_to_state_dict``: Dense and Conv kernels transposed, LayerNorm
    scales renamed);
  * the optimizer state, onto the port optimizer's ``state_dict``
    (``scae_tpu_torch/optim.py``) with the same transposes: RMSprop's
    ``nu`` and momentum ``trace``, Adam's and RAdam's ``mu`` and ``nu``,
    LookAhead's slow weights; each ``count`` from the optax state (the
    run's step where the chain keeps none);
  * the step, and the seed from ``train_seed.json``;
  * the step's metrics. JAX's PRNG key (``rng``) cannot be replayed in
    torch: it is kept in ``metrics.json`` as provenance, as the floats
    ``jax_rng_0`` and ``jax_rng_1`` (its two uint32 words, exact).

The overrides are the dotted ones the run was trained with, as the JAX CLI
takes them; they set the model, the optimizer (which the state must fit)
and the monitor. The source directory is only read: OUT_DIR may not lie
inside it, and Orbax's manager, which creates its directory when it is
missing, finds it there. The last line printed is a JSON object: the
step, the source and the output checkpoint.
"""

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from scae_tpu.config import load_config as jax_load_config  # noqa: E402
from scae_tpu.factory import make_scae as jax_make_scae  # noqa: E402
from scae_tpu.optim import make_optimizer as jax_make_optimizer  # noqa
from scae_tpu.parallel.train_step import TrainState  # noqa: E402
from scae_tpu.train.checkpoint import CheckpointManager as JaxManager  # noqa
from scae_tpu_torch import factory  # noqa: E402
from scae_tpu_torch.config import load_config  # noqa: E402
from scae_tpu_torch.optim import Lookahead, make_optimizer  # noqa: E402
from scae_tpu_torch.parallel.train_step import TrainState as PortState  # noqa
from scae_tpu_torch.tools.ensemble_pool import split_args  # noqa: E402
from scae_tpu_torch.train.checkpoint import (CheckpointManager,  # noqa: E402
                                             load_payload)
from scae_tpu_torch.utils.from_flax import flax_to_state_dict  # noqa: E402

SEED_FILE = "train_seed.json"


def optimizer_kwargs(cfg) -> dict:
    """The harness' optimizer arguments of a config, shared by both
    packages' ``make_optimizer`` (the decay's step count only sets the
    schedule, not the state)."""
    opt, la = cfg["optimizer"], cfg.get("lookahead") or {}
    return dict(name=opt["name"], learning_rate=opt["learning_rate"],
                batch_size=cfg["data_loader"]["batch_size"],
                momentum=opt.get("momentum", 0.9),
                use_lookahead=cfg.get("use_lookahead", False),
                lookahead_alpha=la.get("alpha", 0.5),
                lookahead_k=la.get("k", 6),
                lr_decay_rate=(cfg.get("lr_scheduler") or {})
                .get("decay_rate"))


def abstract_state(cfg) -> TrainState:
    """The shapes and dtypes of a JAX ``TrainState`` of ``cfg``, as Orbax
    restores into them (nothing computed)."""
    model = jax_make_scae(cfg["model"])
    tx = jax_make_optimizer(**optimizer_kwargs(cfg))
    c, h, w = cfg["model"]["image_shape"]
    key = jax.random.PRNGKey(0)

    def init():
        params = model.init({"params": key, "noise": key},
                            jnp.zeros((2, c, h, w)),
                            deterministic=False)["params"]
        return TrainState(step=jnp.zeros([], jnp.int32), params=params,
                          opt_state=tx.init(params), rng=key)

    return jax.eval_shape(init)


def _fields(state) -> dict:
    """The named fields of an optax state: a NamedTuple's, or those of
    every member of a chain (a tuple); the first of a name wins."""
    if hasattr(state, "_fields"):
        return {k: getattr(state, k) for k in state._fields}
    out = {}
    if isinstance(state, (tuple, list)):
        for member in state:
            for k, v in _fields(member).items():
                out.setdefault(k, v)
    return out


def convert_opt_state(opt_state, optimizer, names, step: int) -> dict:
    """The port ``optimizer``'s ``state_dict`` from a JAX optax state:
    each parameter-shaped tree converted as the parameters are and listed
    in the order of ``names`` (the model's parameters)."""
    def leaves(tree):
        sd = flax_to_state_dict(jax.device_get(tree))
        return [sd[n] for n in names]

    if isinstance(optimizer, Lookahead):
        return {"count": int(opt_state.step),
                "slow": leaves(opt_state.slow_params),
                "base": convert_opt_state(opt_state.inner_state,
                                          optimizer.base, names, step)}
    fields = _fields(opt_state)
    out = {}
    for name in optimizer._state:
        if name == "count":
            out[name] = int(fields["count"]) if "count" in fields else step
        elif getattr(optimizer, name) is None:
            out[name] = None
        elif name not in fields:
            raise ValueError(f"the run's optimizer state has no {name!r} "
                             f"(fields {sorted(fields)}); is the "
                             "optimizer in the overrides the run's?")
        else:
            out[name] = leaves(fields[name])
    return out


def main(argv=None) -> dict:
    argv, overrides = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run", help="the scae_tpu run's checkpoint directory")
    ap.add_argument("--out", required=True,
                    help="the port checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to import (default: the best by the "
                         "config's monitor, else the latest)")
    args = ap.parse_args(argv)
    run, out = os.path.realpath(args.run), os.path.realpath(args.out)
    if not os.path.isdir(run):
        raise FileNotFoundError(f"no run directory {args.run}")
    if out == run or out.startswith(run + os.sep):
        raise ValueError(f"--out {args.out} lies inside the source run "
                         f"{args.run}, which is only read")

    jcfg = jax_load_config("config", overrides=overrides)
    cfg = load_config("config", overrides=overrides)
    monitor = cfg["trainer"].get("monitor", "val_loss")
    mode = cfg["trainer"].get("monitor_mode", "min")
    src = JaxManager(run, monitor=monitor, mode=mode)
    try:
        step = args.step
        if step is None:
            step = src.best_step if src.best_step is not None \
                else src.latest_step
        if step is None:
            raise FileNotFoundError(f"{args.run} holds no checkpoint")
        state = src.restore(abstract_state(jcfg), step=step)
        metrics = dict(src.metrics(step) or {})
    finally:
        src.close()
    seed_record = None
    if os.path.exists(os.path.join(run, SEED_FILE)):
        with open(os.path.join(run, SEED_FILE)) as f:
            seed_record = json.load(f)
    seed = int(seed_record["seed"]) if seed_record else cfg.get("seed", 42)

    model = factory.make_scae(dict(cfg["model"]), device="cpu", seed=seed)
    optimizer = make_optimizer(model.parameters(),
                               **optimizer_kwargs(cfg))
    names = [n for n, _ in model.named_parameters()]
    payload = {
        "model": flax_to_state_dict(jax.device_get(state.params)),
        "optimizer": convert_opt_state(state.opt_state, optimizer, names,
                                       int(state.step)),
        "step": int(state.step), "seed": seed}
    # strict: every name, shape and list length the port's state holds
    load_payload(PortState(model, optimizer), payload)
    rng = np.asarray(jax.device_get(state.rng)).astype(np.uint32)
    metrics.update(jax_rng_0=float(rng[0]), jax_rng_1=float(rng[1]))

    os.makedirs(out, exist_ok=True)
    dst = CheckpointManager(out, monitor=monitor, mode=mode)
    if not dst.save(int(state.step), payload, metrics):
        raise FileExistsError(f"{args.out} already holds a checkpoint at "
                              f"or after step {int(state.step)}")
    if seed_record is not None:
        shutil.copyfile(os.path.join(run, SEED_FILE),
                        os.path.join(out, SEED_FILE))
    result = {"step": int(state.step), "source": args.run,
              "out": os.path.join(args.out, str(int(state.step))),
              "seed": seed, "params": int(sum(
                  v.numel() for v in payload["model"].values()))}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
