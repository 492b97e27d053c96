"""scae_tpu_torch/tools/pool_inprocess.py, the port's twin of
tools/pool_inprocess.py, on the CPU at a tiny width (the port's twin of
tests/test_train_smoke.py::test_pool_inprocess_matches_solo_run):

  * a member trained inside the one-process runner after another member
    (a different seed, trained first in the same process) is parameter
    for parameter, bit for bit, the same recipe trained alone, and the
    other member differs;
  * the skip rules: a member marked DONE is not trained again, a member
    already calibrated is not calibrated again; calibrate_members bakes a
    probe into each member's head through tools/probe_calibrate.py.
"""

import os

import torch

from scae_tpu_torch.config import load_config
from scae_tpu_torch.tools import pool_inprocess as pi
from scae_tpu_torch.train.checkpoint import CheckpointManager
from scae_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

TINY_MODEL = [
    "model.image_shape=[1,24,24]",
    "model.n_part_caps=8",
    "model.n_obj_caps=4",
    "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]",
    "model.pcae_template_generator_params.template_size=[6,6]",
    "model.ocae_encoder_set_transformer_params.dim_hidden=8",
    "model.ocae_encoder_set_transformer_params.dim_out=16",
    "model.ocae_decoder_capsule_params.dim_caps=8",
    "model.ocae_decoder_capsule_params.hidden_sizes=[16]",
]
BASE = [
    "data_loader.batch_size=16",
    "data_loader.source=synthetic",
    "data_loader.synthetic_train=64",
    "data_loader.val_size=32",
    "data_loader.synthetic_test=16",
    "data_loader.split_seed=7",
    "trainer.log_every_steps=2",
    "trainer.max_eval_batches=1",
    "trainer.augment.canvas=24",
    "trainer.augment.max_shift=2",
    *TINY_MODEL,
]


def final_params(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir, monitor="val_loss", mode="min")
    step = mgr.latest_step
    return step, mgr.restore_params(step=step)


def test_pool_member_matches_solo_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")
    solo_ckpt = f"{tmp_path}/solo"
    trainer = Trainer(load_config("config", overrides=BASE + [
        "seed=7", "trainer.max_epochs=2",
        f"trainer.log_dir={tmp_path}/solo_logs",
        f"trainer.checkpoint_dir={solo_ckpt}"]), device="cpu")
    trainer.run(max_epochs=2)
    trainer.close()

    members = [("m0", 2, ["seed=3"]), ("m1", 2, ["seed=7"])]
    kw = dict(log_root=f"{tmp_path}/pool_logs",
              ckpt_root=f"{tmp_path}/pool", base_overrides=BASE,
              device="cpu")
    pi.train_members(members=members, **kw)
    s_step, solo = final_params(solo_ckpt)
    m_step, pooled = final_params(f"{tmp_path}/pool/m1")
    assert s_step == m_step
    assert sorted(solo) == sorted(pooled)
    for k in solo:
        assert torch.equal(solo[k], pooled[k]), k
    _, other = final_params(f"{tmp_path}/pool/m0")
    assert any(not torch.equal(other[k], solo[k]) for k in solo)
    for name, _, _ in members:
        log_dir = os.path.join(kw["log_root"], name)
        assert os.path.exists(os.path.join(log_dir, pi.DONE))
        assert os.path.getsize(os.path.join(log_dir, "stdout.log")) > 0

    # a second pass skips both members
    capsys.readouterr()
    pi.train_members(members=members, **kw)
    assert capsys.readouterr().out.count("already done, skipping") == 2

    # the calibration pass, and its skip rule
    monkeypatch.setattr(pi, "EVAL_OVERRIDES", BASE)
    ckw = dict(ckpt_root=kw["ckpt_root"], out_root=f"{tmp_path}/calibrated",
               log_path=f"{tmp_path}/calibrated_logs/calibrate.log",
               device="cpu")
    pi.calibrate_members(members=members, **ckw)
    for name, _, _ in members:
        step, head = final_params(f"{tmp_path}/calibrated/{name}")
        _, source = final_params(f"{tmp_path}/pool/{name}")
        assert step == m_step
        assert not torch.equal(head["posterior_classifier.weight"],
                               source["posterior_classifier.weight"])
        assert torch.equal(head["prior_classifier.weight"],
                           source["prior_classifier.weight"])
    capsys.readouterr()
    pi.calibrate_members(members=members, **ckw)
    assert capsys.readouterr().out.count("already calibrated, skipping") == 2


def test_members_and_overrides_are_the_jax_runners():
    """The same pool, recipe and evaluation overrides as the JAX runner
    (tools/pool_inprocess.py), read from its source text: the port may not
    import it."""
    import ast

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "tools", "pool_inprocess.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in (
                    "FLAG", "MEMBERS", "EVAL_OVERRIDES"):
            found[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), "pool_inprocess", "eval"))
    assert found == {"FLAG": pi.FLAG, "MEMBERS": pi.MEMBERS,
                     "EVAL_OVERRIDES": pi.EVAL_OVERRIDES}
