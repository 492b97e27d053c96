"""The port's Trainer and CLI on a mesh of gloo processes against the
port's own single-process run, on the CPU, as tests/test_multiprocess.py
holds scae_tpu's two-process run to its one-process run, and with its
tolerances: the parameters' sum of squares and sum of magnitudes within
rtol 1e-6, the per-step loss terms of the JSONL within rtol 1e-5.

  * ``python -m scae_tpu_torch.train.cli`` (``cli.main``) with
    ``trainer.mesh`` 2x1 and 1x2 on two processes, noise and translation
    on, the between-example sparsity weights on (0.35, 0.2): 4 steps, then
    a resume to 6, then ``mode=test``. Both processes hold the same
    parameters; they equal the single-process run's; process 0's JSONL
    equals the single-process JSONL step for step; process 1 writes no
    metrics; the resume equals a straight 6-step run; ``mode=test`` gives
    the single-process test loss and leaves out the per-class recall on
    more than one process, as scae_tpu does.
  * ``shard_state`` on 1x2 (the capsule banks split over the model
    group): 2 raw train steps, ``unshard_state`` and a checkpoint, which a
    single process restores to the single-process run's parameters; and a
    single-process checkpoint restored on the mesh, split, trained 2 steps
    further and gathered, against the single-process run's 4 steps.

  * the seed probe and the head refit on 2x1 (``trainer.seed_probe`` of 2
    candidates of 1 epoch, ``trainer.head_refit`` under a val_accuracy
    monitor, in one run of 2 epochs): the candidates' scores within 1e-5
    relative of the single-process run's, whose winner both processes
    pick and continue; ``train_seed.json`` written once, by process 0;
    the refit's C* that of a single-process refit from the same best
    checkpoint, its head within LOGREG_TOL (1e-3 of its largest entry) of
    that refit's, every other tensor bit for bit the source checkpoint's;
    one refit checkpoint, and the same best and latest step on every
    process.

This file's ``__main__`` is the rank worker. Each multi-process case runs
under a timeout of its own and kills its ranks when one fails.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scae_tpu_torch.factory import make_scae as t_make_scae  # noqa: E402
from scae_tpu_torch.optim import make_optimizer  # noqa: E402
from scae_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from scae_tpu_torch.parallel import train_step as ts  # noqa: E402
from scae_tpu_torch.train import cli  # noqa: E402
from scae_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from scae_tpu_torch.config import load_config  # noqa: E402
from scae_tpu_torch.train.loop import Trainer, make_augment_fn  # noqa: E402

torch.set_num_threads(1)
RANKS_TIMEOUT = 180      # seconds for one multi-process case
LOGREG_TOL = 1e-3        # test_torch_trainer_features.py's
# 32 training images of batch 16: 2 steps an epoch
BASE = [
    "data_loader.batch_size=16", "data_loader.source=synthetic",
    "data_loader.synthetic_train=64", "data_loader.val_size=32",
    "data_loader.synthetic_test=24", "trainer.log_every_steps=1",
    "trainer.max_eval_batches=1", "trainer.augment.canvas=24",
    "trainer.augment.max_shift=2", "model.image_shape=[1,24,24]",
    "model.n_part_caps=8", "model.n_obj_caps=4",
    "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]",
    "model.pcae_cnn_encoder_params.compute_dtype=null",
    "model.pcae_decoder_params.fused_tap_dtype=float32",
    "model.pcae_template_generator_params.template_size=[6,6]",
    "model.ocae_encoder_set_transformer_params.dim_hidden=8",
    "model.ocae_encoder_set_transformer_params.dim_out=16",
    "model.ocae_decoder_capsule_params.dim_caps=8",
    "model.ocae_decoder_capsule_params.hidden_sizes=[16]",
    "model.scae_params.prior_between_example_sparsity_weight=0.35",
    "model.scae_params.posterior_between_example_sparsity_weight=0.2",
]
LOSS_KEYS = ("rec_ll_loss", "log_prob_loss", "prior_within_sparsity_loss",
             "prior_between_sparsity_loss", "posterior_within_sparsity_loss",
             "posterior_between_sparsity_loss", "cpr_dynamic_reg_loss",
             "prior_cls_xe", "posterior_cls_xe", "loss")
# the runs of a launch, in order: 4 steps, a resume to 6, mode=test
RUNS = (["trainer.max_epochs=2"], ["trainer.max_epochs=3", "resume=true"],
        ["trainer.max_epochs=3", "mode=test"])
MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)),
    scae_params=dict(reconstruct_alternatives=False,
                     prior_between_example_sparsity_weight=0.35,
                     posterior_between_example_sparsity_weight=0.2))


def rank_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                SCAE_TPU_NO_TENSORBOARD="1")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")


def checksums(model):
    """(sum of squares, sum of magnitudes) of every parameter, in float64:
    tests/two_process_worker.py's params_l2 and params_abs_sum."""
    params = [p.detach().double() for p in model.parameters()]
    return (float(sum((p * p).sum() for p in params)),
            float(sum(p.abs().sum() for p in params)))


def run_cli(out, rank, argv):
    """``cli.main`` on the CPU with the shared checkpoints in ``out`` and
    the logs of process ``rank`` in ``out/logs_p<rank>``."""
    return cli.main(BASE + argv + [f"trainer.checkpoint_dir={out}/ckpt",
                                   f"trainer.log_dir={out}/logs_p{rank}"],
                    device="cpu")


def record(result):
    """What a run returns, as JSON: the state's step and checksums, or the
    test metrics."""
    if isinstance(result, dict):
        return {"metrics": result}
    return {"step": result.step, "checksums": checksums(result.model)}


def train_records(out, rank=0):
    with open(os.path.join(out, f"logs_p{rank}", "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "images_per_sec" in r]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The single-process runs: 4 steps; 6 steps straight, then
    mode=test."""
    four = tmp_path_factory.mktemp("one_process_4")
    six = tmp_path_factory.mktemp("one_process_6")
    return {"four": (four, record(run_cli(four, 0, RUNS[0]))),
            "six": (six, record(run_cli(six, 0, RUNS[1][:1]))),
            "test": record(run_cli(six, 0, RUNS[2]))}


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)])
def test_cli_on_a_mesh_matches_one_process(tmp_path, one_process, n_data,
                                           n_model):
    outputs = mesh_lib.run_local(
        [sys.executable, __file__, "cli", str(tmp_path),
         f"trainer.mesh.n_data={n_data}", f"trainer.mesh.n_model={n_model}"],
        2, RANKS_TIMEOUT, env=rank_env())
    assert "distributed: process 0/2 (gloo)" in outputs[0]
    assert "distributed: process" not in outputs[1]
    with open(tmp_path / "results.json") as f:
        results = json.load(f)       # [run][rank]
    four, want4 = one_process["four"]
    six, want6 = one_process["six"]
    for run, want in ((0, want4), (1, want6)):
        got = results[run]
        assert got[0]["step"] == got[1]["step"] == want["step"]
        # both processes hold the same parameters...
        np.testing.assert_allclose(got[0]["checksums"], got[1]["checksums"],
                                   rtol=1e-12)
        # ...the single-process run's
        np.testing.assert_allclose(got[0]["checksums"], want["checksums"],
                                   rtol=1e-6)
    # process 0's records are the single-process run's, the resume's
    # included; process 1 writes none
    got, want = train_records(tmp_path), train_records(six)
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == [1, 2, 3, 4, 5, 6]
    # (a straight run's first 4 steps are the 4-step run's)
    assert [r["loss"] for r in train_records(four)] == [
        r["loss"] for r in want[:4]]
    for g, w in zip(got, want):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"{k} at step {g['step']}")
    assert not os.path.exists(tmp_path / "logs_p1")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "4", "6",
                                                     "train_seed.json"]
    # mode=test: the single-process test loss, no per-class recall
    test, want_test = results[2], one_process["test"]["metrics"]
    for rank in range(2):
        got = test[rank]["metrics"]
        assert not any(k.startswith("test_class") for k in got)
        assert "test_accuracy_scan" not in got
        for k in ("test_loss", "test_rec_ll_loss"):
            np.testing.assert_allclose(got[k], want_test[k], rtol=1e-5,
                                       err_msg=k)
        # without the recall pass the accuracy is the scan's, over
        # floor(n / B) batches
        assert got["test_accuracy"] == want_test["test_accuracy_scan"]


def cli_ranks(out, mesh_argv):
    """A rank of ``test_cli_on_a_mesh_matches_one_process``: the RUNS in
    turn; process 0 writes every rank's records to ``out/results.json``."""
    import torch.distributed as dist

    results = []
    for argv in RUNS:
        mine = record(run_cli(out, int(os.environ["RANK"]),
                              argv + mesh_argv))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        results.append(every)
    if dist.get_rank() == 0:
        with open(os.path.join(out, "results.json"), "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


# ------------------------------------------------- shard_state checkpoints

def new_state(seed=0):
    model = t_make_scae(MODEL, device="cpu", seed=seed)
    return ts.TrainState(model, make_optimizer(model.parameters(),
                                               "rmsprop", 3e-5, 16))


def steps(state, first, last, mesh=None):
    """Raw train steps ``first`` to ``last`` (counted from 1), noise and
    translation on, each on its own batch of 16 made from a seed."""
    step = ts.make_raw_train_step(state, make_augment_fn(24, 2),
                                  device="cpu", mesh=mesh)
    for k in range(first, last + 1):
        rng = np.random.RandomState(k)
        step(rng.randint(0, 256, (16, 20, 20)).astype(np.uint8),
             rng.randint(0, 10, (16,)))
    return state


def test_shard_state_checkpoints_restore_across_meshes(tmp_path):
    single = new_state()
    steps(single, 1, 2)
    CheckpointManager(str(tmp_path / "single")).save(2, single)
    at2 = checksums(single.model)
    at4 = checksums(steps(single, 3, 4).model)
    mesh_lib.run_local([sys.executable, __file__, "banks", str(tmp_path)], 2,
                       RANKS_TIMEOUT, env=rank_env())
    # the 1x2 run's checkpoint, restored in one process
    restored = CheckpointManager(str(tmp_path / "from_mesh")).restore(
        new_state(seed=5))
    assert restored.step == 2
    np.testing.assert_allclose(checksums(restored.model), at2, rtol=1e-6)
    # the single-process checkpoint, trained on by the 1x2 mesh
    onto = CheckpointManager(str(tmp_path / "onto_mesh")).restore(
        new_state(seed=5))
    assert onto.step == 4
    np.testing.assert_allclose(checksums(onto.model), at4, rtol=1e-6)


def bank_ranks(out):
    """A rank of ``test_shard_state_checkpoints_restore_across_meshes`` on
    1x2: train with the banks split, gather, and checkpoint on process
    0."""
    import torch.distributed as dist

    assert mesh_lib.maybe_initialize_distributed()
    mesh = mesh_lib.make_mesh(n_data=1, n_model=2)
    for source, target, first, last in ((None, "from_mesh", 1, 2),
                                        ("single", "onto_mesh", 3, 4)):
        state = new_state(seed=0 if source is None else 5)
        if source is not None:
            CheckpointManager(os.path.join(out, source)).restore(state)
        ts.shard_state(state, mesh)
        assert len(state.banks) == 11
        steps(state, first, last, mesh)
        ts.unshard_state(state, mesh)
        if mesh_lib.is_process_zero():
            CheckpointManager(os.path.join(out, target)).save(last, state)
        mesh_lib.barrier()
    dist.destroy_process_group()


# ------------------------------------------- seed probe and head refit

# seed 1's two candidates score 4e-3 apart (seed 42's, 7e-6)
OPTIONS = ["seed=1", "trainer.max_epochs=2", "trainer.seed_probe.n=2",
           "trainer.seed_probe.epochs=1", "trainer.head_refit=true",
           "trainer.monitor=val_accuracy", "trainer.monitor_mode=max"]


def options_trainer(out, tag, extra=()):
    return Trainer(load_config("config", BASE + OPTIONS + list(extra) + [
        f"trainer.checkpoint_dir={out}/{tag}/ckpt",
        f"trainer.log_dir={out}/{tag}/logs"]), device="cpu")


def recording_evaluate(scores):
    """``Trainer.evaluate``, appending each pass's val_rec_ll_loss (the
    seed probe's score, unrounded) to ``scores``."""
    evaluate = Trainer.evaluate

    def recording(self, dataset, max_batches=None):
        metrics, viz = evaluate(self, dataset, max_batches)
        scores.append(metrics["val_rec_ll_loss"])
        return metrics, viz

    return recording


def test_seed_probe_and_head_refit_on_a_mesh(tmp_path, monkeypatch,
                                             capsys):
    scores = []
    monkeypatch.setattr(Trainer, "evaluate", recording_evaluate(scores))
    one = options_trainer(tmp_path, "one")
    try:
        one_state = one.run()
    finally:
        one.close()
    # the probe's two evals come first
    want = dict(zip((1, 2), scores[:2]))
    winner = min(want, key=lambda s: (want[s], s))
    assert abs(want[1] - want[2]) > 1e-5 * max(want.values())
    assert f"seed probe winner: {winner} " in capsys.readouterr().out
    outputs = mesh_lib.run_local(
        [sys.executable, __file__, "options", str(tmp_path)], 2,
        RANKS_TIMEOUT, env=rank_env())
    with open(tmp_path / "options.json") as f:
        ranks = json.load(f)
    # the candidates' scores are the single-process run's, and the
    # processes agree on its winner; only process 0 speaks
    for r in ranks:
        got = dict(zip((1, 2), r["scores"][:2]))
        for s in got:
            np.testing.assert_allclose(got[s], want[s], rtol=1e-5,
                                       err_msg=f"seed {s}")
    assert f"seed probe winner: {winner} " in outputs[0]
    assert "seed probe" not in outputs[1] and "head_refit" not in outputs[1]
    assert [r["seed"] for r in ranks] == [winner, winner]
    assert one_state.seed == winner
    assert [r["train_seed_writes"] for r in ranks] == [1, 0]
    ckpt = tmp_path / "mesh" / "ckpt"
    with open(ckpt / "train_seed.json") as f:
        assert json.load(f) == {"seed": winner, "split_seed": None}
    # one refit checkpoint, past the run's last; every process's manager
    # sees what the directory holds
    assert ranks[0]["kept"] == ranks[1]["kept"] == [4, 5]
    assert sorted(os.listdir(ckpt)) == ["4", "5", "train_seed.json"]
    best = CheckpointManager(str(ckpt), monitor="val_accuracy",
                             mode="max").best_step
    assert [(r["best"], r["latest"]) for r in ranks] == [(best, 5)] * 2
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    c_star = re.search(r"head_refit: C\*=(\S+) ", outputs[0]).group(1)
    # a single process's refit from the same best checkpoint
    alone = tmp_path / "alone" / "ckpt"
    alone.mkdir(parents=True)
    shutil.copytree(ckpt / "4", alone / "4")
    t = options_trainer(tmp_path, "alone")
    try:
        t.build_steps(2)
        train, val = t._load_datasets(winner)[:2]
        assert t.refit_head(train, val) is not None
        want_head = t.ckpt.restore_params(step=5)
    finally:
        t.close()
    assert re.search(r"head_refit: C\*=(\S+) ",
                     capsys.readouterr().out).group(1) == c_star
    src = CheckpointManager(str(ckpt)).restore_params(step=4)
    refit = CheckpointManager(str(ckpt)).restore_params(step=5)
    for k, v in src.items():
        if k.startswith("posterior_classifier."):
            ref = want_head[k].numpy()
            np.testing.assert_allclose(refit[k].numpy(), ref, rtol=0,
                                       atol=LOGREG_TOL * np.abs(ref).max(),
                                       err_msg=k)
        else:
            assert torch.equal(refit[k], v), k
    assert not torch.equal(refit["posterior_classifier.weight"],
                           src["posterior_classifier.weight"])


def options_ranks(out):
    """A rank of ``test_seed_probe_and_head_refit_on_a_mesh``: the run on
    2x1, counting this process's writes of train_seed.json; process 0
    writes every rank's record to ``out/options.json``."""
    import builtins

    import torch.distributed as dist

    writes = []
    real_open = builtins.open

    def counting_open(file, mode="r", *args, **kwargs):
        if str(file).endswith("train_seed.json") and "w" in mode:
            writes.append(file)
        return real_open(file, mode, *args, **kwargs)

    assert mesh_lib.maybe_initialize_distributed("gloo")
    scores = []
    Trainer.evaluate = recording_evaluate(scores)
    builtins.open = counting_open
    try:
        t = options_trainer(out, "mesh", ["trainer.mesh.n_data=2"])
        state = t.run()
        mine = {"seed": state.seed, "step": state.step, "scores": scores,
                "train_seed_writes": len(writes),
                "best": t.ckpt.best_step, "latest": t.ckpt.latest_step,
                "kept": sorted(t.ckpt._metrics),
                "checksums": checksums(state.model)}
        t.close()
    finally:
        builtins.open = real_open
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() == 0:
        with open(os.path.join(out, "options.json"), "w") as f:
            json.dump(every, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "options":
        options_ranks(sys.argv[2])
    elif sys.argv[1] == "cli":
        cli_ranks(sys.argv[2], sys.argv[3:])
    elif sys.argv[1] == "banks":
        bank_ranks(sys.argv[2])
