"""The plain reference against scae_tpu_torch at a tiny size on the CPU,
and the import rules: nothing under portbench/ imports JAX or the JAX
package, and the reference imports nothing of scae_tpu_torch."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, weights
from portbench.reference import train as ref_train
from portbench.reference.model import Model
from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "scae_tpu"}


def imported_top_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(harness.PB, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "scae_tpu_torch" not in imported_top_names(path), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.model, portbench.reference.train; "
            "bad = {m.split('.')[0] for m in sys.modules} & %r | "
            "({'scae_tpu_torch'} & {m.split('.')[0] for m in sys.modules}); "
            "print(sorted(bad)); sys.exit(1 if bad else 0)"
            % (harness.ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture(scope="module")
def pair():
    from scae_tpu_torch import factory

    ref = Model(tiny.MODEL)
    port = factory.make_scae(tiny.MODEL, device="cpu")
    w = weights.draw(weights.shapes_of(ref), 11, "cpu")
    ref.load_state_dict(w)
    port.load_state_dict(w)
    return ref, port


def test_parameter_names_and_shapes_match(pair):
    ref, port = pair
    assert weights.shapes_of(ref) == weights.shapes_of(port)


@pytest.mark.parametrize("noise", [False, True])
def test_loss_terms_and_gradients_agree(pair, noise):
    ref, port = pair
    x = torch.rand(6, 1, 24, 24, generator=torch.Generator().manual_seed(1))
    labels = torch.arange(6) % 10
    g_ref = torch.Generator().manual_seed(3) if noise else None
    g_port = torch.Generator().manual_seed(3) if noise else None
    loss_r, terms_r = ref.loss(ref(x, generator=g_ref), labels)
    res = port(x, deterministic=not noise, generator=g_port)
    loss_p, terms_p = port.loss(res, x, labels)
    for k, v in terms_r.items():
        assert float(terms_p[k].detach()) == pytest.approx(float(v), rel=1e-5,
                                                  abs=1e-6), k
    gr = torch.autograd.grad(loss_r, list(ref.parameters()),
                             allow_unused=True)
    gp = torch.autograd.grad(loss_p, list(port.parameters()),
                             allow_unused=True)
    names = [n for n, _ in port.named_parameters()]
    by_name = dict(zip([n for n, _ in ref.named_parameters()], gr))
    for n, g in zip(names, gp):
        r = by_name[n]
        if g is None or r is None:
            assert (g is None or float(g.abs().max()) == 0) and \
                (r is None or float(r.abs().max()) == 0), n
            continue
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) <= 1e-3 * scale, n


def test_serving_outputs_agree(pair):
    from scae_tpu_torch.serve import make_infer_fn

    ref, port = pair
    x = torch.rand(5, 1, 24, 24, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        r = ref.serve(x)
    p = make_infer_fn(port, device="cpu")(x)
    for k, v in r.items():
        assert torch.allclose(p[k], v, atol=1e-6), k


def test_translation_draws_match_the_port():
    from scae_tpu_torch.train.loop import make_augment_fn

    x = torch.rand(4, 1, 20, 20)
    aug = make_augment_fn(24, 2)
    a = aug({"image": x}, torch.Generator().manual_seed(5))["image"]
    b = ref_train.translate(ref_train.pad_to(x, 24),
                            torch.Generator().manual_seed(5), 2)
    assert torch.equal(a, b)


def test_step_seeds_match_the_port():
    from scae_tpu_torch.parallel import train_step

    for seed in (0, 2 ** 31 + 5):
        for step in (0, 1, 428):
            assert ref_train.fold_in(seed, step, 7) == \
                train_step._fold_in(seed, step, 7)
            assert ref_train.fold_in(seed, step) == \
                train_step._fold_in(seed, step)
