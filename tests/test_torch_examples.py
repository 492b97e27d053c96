"""The port's two examples (scae_tpu_torch/examples/) on the CPU, cut to
seconds:

  * train_resume_demo, its data cut to 64 training images (2 steps an
    epoch at its batch of 32): the second run resumes at the step the first stopped at and
    ends at epoch 4, and every step is trained once; infer_demo then
    serves its best checkpoint and writes its two outputs;
  * infer_demo against the JAX package's examples/infer_demo.py on twin
    checkpoints: a JAX Trainer's initial state saved by scae_tpu's
    CheckpointManager and carried to the port by
    tools/import_jax_checkpoint.py. The same predictions, confidences
    within 1e-4, the same labels, presence masses within their rounding
    (3 decimals). Both sides with f32 convolutions: the demo's config
    computes them in bf16, whose rounding two backends need not share.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from scae_tpu_torch.examples import infer_demo, train_resume_demo

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = {"data_loader.synthetic_train": "96",
       "data_loader.synthetic_test": "40",
       "data_loader.val_size": "32",
       "trainer.max_eval_batches": "1"}
F32 = "model.pcae_cnn_encoder_params.compute_dtype=null"


def cut_overrides():
    out = []
    for o in train_resume_demo.OVERRIDES:
        key = o.split("=", 1)[0]
        out.append(f"{key}={CUT[key]}" if key in CUT else o)
    return out


def load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")


def test_train_resume_then_infer(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train_resume_demo, "OVERRIDES", cut_overrides())
    state = train_resume_demo.main([str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[demo] interrupted at step 4;" in out
    assert "[scae_tpu_torch] resumed from step 4" in out
    assert state.step == 8
    steps = [r["step"] for r in read_jsonl(
        tmp_path / "logs" / "metrics.jsonl") if "images_per_sec" in r]
    # every step trained once: the resume continued where the first run
    # stopped
    assert steps == sorted(set(steps)) and steps[-1] == 8
    assert any(s <= 4 for s in steps) and any(s > 4 for s in steps)

    got = infer_demo.main([*cut_overrides(),
                           f"trainer.checkpoint_dir={tmp_path}/ckpt",
                           f"trainer.log_dir={tmp_path}/infer_logs",
                           f"--out={tmp_path}/infer", "--device=cpu"])
    records = read_jsonl(tmp_path / "infer" / "predictions.jsonl")
    assert len(records) == 40 == len(got["records"])
    assert [r["index"] for r in records] == list(range(40))
    assert os.path.getsize(tmp_path / "infer" / "inference_grid.png") > 0


def test_infer_demo_matches_the_jax_demo(tmp_path):
    import jax

    from scae_tpu.config import load_config as j_load_config
    from scae_tpu.train.loop import Trainer as JaxTrainer

    base = cut_overrides() + [F32]
    jax_dir, port_dir = tmp_path / "jax_ckpt", tmp_path / "port_ckpt"
    trainer = JaxTrainer(j_load_config("config", overrides=base + [
        f"trainer.checkpoint_dir={jax_dir}",
        f"trainer.log_dir={tmp_path}/jax_logs"]))
    trainer.build_steps(2)
    state = trainer.init_state(7)
    trainer.ckpt.save(3, state.replace(step=jax.numpy.int32(3)),
                      {"val_loss": 1.0})
    trainer.ckpt.wait()
    trainer.ckpt.close()
    with open(jax_dir / "train_seed.json", "w") as f:
        json.dump({"seed": 7, "split_seed": None}, f)

    importer = load_file("import_jax_checkpoint", os.path.join(
        REPO, "tools", "import_jax_checkpoint.py"))
    importer.main([str(jax_dir), "--out", str(port_dir), "--", *base])

    jax_demo = load_file("jax_infer_demo", os.path.join(
        REPO, "examples", "infer_demo.py"))
    jax_demo.main([*base, f"trainer.checkpoint_dir={jax_dir}",
                   f"trainer.log_dir={tmp_path}/jax_infer_logs",
                   f"--out={tmp_path}/jax_out"])
    infer_demo.main([*base, f"trainer.checkpoint_dir={port_dir}",
                     f"trainer.log_dir={tmp_path}/port_infer_logs",
                     f"--out={tmp_path}/port_out", "--device=cpu"])
    want = read_jsonl(tmp_path / "jax_out" / "predictions.jsonl")
    got = read_jsonl(tmp_path / "port_out" / "predictions.jsonl")
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert (g["index"], g["pred"], g["label"]) == (
            w["index"], w["pred"], w["label"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4 + 1e-9
        assert abs(g["capsule_presence_mass"]
                   - w["capsule_presence_mass"]) <= 1e-3 + 1e-9
    # the classes are not all one: the comparison sees the argmax move
    assert len({r["pred"] for r in want}) > 1 or len(
        {r["confidence"] for r in want}) > 1
    for side in ("jax_out", "port_out"):
        assert os.path.getsize(tmp_path / side / "inference_grid.png") > 0
