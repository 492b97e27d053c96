"""A tiny configuration and traffic for CPU tests of the harness: the
benchmark's code at sizes a test run holds."""

import copy
import json
import os

import torch

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL = dict(image_shape=[1, 24, 24], n_classes=10, n_part_caps=8,
             n_obj_caps=4,
             pcae_cnn_encoder_params=dict(out_channels=[16, 16, 16, 16]),
             pcae_template_generator_params=dict(template_size=[5, 5]),
             pcae_decoder_params=dict(learn_output_scale=True),
             ocae_encoder_set_transformer_params=dict(dim_out=32),
             ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=[16]),
             scae_params=dict(reconstruct_alternatives=False))

TRAFFIC = {
    "train": (dict(kind="train_job", batch_size=16, log_every_steps=4,
                   checked_steps=3),
              dict(start_gap=0.0, loss_gap=1e-3, grad_gap=2e-4,
                   replay_grad_gap=2e-4, change_gap=4e-3, state_gap=1e-2,
                   eval_gap=5e-5)),
    "online": (dict(kind="serve_open_loop", sizes=[1, 8], shares=[0.75, 0.25],
                    profile_seconds=0.5, sample=5, rate_per_s=40),
               dict(out_gap=5e-6)),
    "bulk": (dict(kind="serve_closed_loop", size=8, profile_seconds=0.5,
                  sample=3),
             dict(out_gap=5e-6)),
}


def config():
    cfg = json.load(open(os.path.join(PB, "configs", "mnist40.json")))
    cfg = copy.deepcopy(cfg)
    cfg["model"] = copy.deepcopy(MODEL)
    cfg["data"] = dict(train=128, val=32, raw_shape=[20, 20, 1], classes=10,
                       canvas=24, max_shift=2)
    return cfg


def run(which, seed=2 ** 31 + 7, seconds=0.5, fault=None):
    """A harness run of the tiny cell ``which`` on the CPU: (checks,
    run)."""
    from portbench import harness

    params, limits = TRAFFIC[which]
    r = harness.Run("tiny." + which, config(), dict(params), dict(limits),
                    seed, seconds, False, torch.device("cpu"), fault=fault)
    checks, _ = harness.execute(r, 0.0)
    return checks, r
