"""The attention kernel's route (K6) against scae_tpu, on the CPU: the
port's ``qkv_attention(..., use_pallas=True)`` (K6's plain version
forward, the plain path's autograd backward) against the JAX package's
``qkv_attention(..., use_pallas=True)``, whose Pallas kernel runs in
interpret mode here and whose custom VJP recomputes the jnp path; and the
set transformer with ``use_pallas_attention`` on both sides, on weights
carried across from flax.

Inputs are made with numpy from a seed and handed to both sides.
Tolerance: 1e-5 relative and absolute on values and gradients, that of
tests/test_pallas_attention.py: the same f32 scores, softmax and
products, summed in another order. Under binary and near-one presences,
where the weights follow the scores, the presence gradient is held
within 1e-5 of its largest entry instead: it carries the mask's 1e9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.models import set_transformer as j_st
from scae_tpu.ops.attention import qkv_attention as j_attention
from scae_tpu_torch.kernels import attention as k6
from scae_tpu_torch.models import set_transformer as t_st
from scae_tpu_torch.ops.attention import qkv_attention
from scae_tpu_torch.utils import trace
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
TOL = 1e-5
# presences under which the weights follow the scores (presence_of)
SCORED = ("binary", "near one")


def inputs(B, N, M, dk, dv, presence, seed=0):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, N, dk), rng.randn(B, M, dk), rng.randn(B, M, dv)]
    if presence is not None:
        arrays.append(presence_of(presence, rng, B, M))
    return [np.asarray(a, np.float32) for a in arrays]


def presence_of(kind, rng, B, M):
    """(B, M) presences of one kind: "soft" uniform in [0, 1), "zero" soft
    with one set all absent, "binary" 0 or 1, "ones", or "near one": 1 or
    1 - 2^-24 or 1 - 2^-23, the nearest f32 values below 1, where the
    penalty (1 - p) * 1e9 (60 and 119) is as large as the scores, so that
    masking before or after the scaling gives another softmax."""
    if kind == "ones":
        return np.ones((B, M))
    if kind == "binary":
        return (rng.rand(B, M) < 0.5).astype(np.float64)
    if kind == "near one":
        return 1.0 - rng.randint(0, 3, (B, M)) * 2.0 ** -24
    p = rng.rand(B, M)
    if kind == "zero":
        p[0] = 0.0       # one set with every element absent
    return p


def close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                               err_msg=err_msg)


@pytest.mark.parametrize("B,N,M,dk,dv,presence", [
    (3, 5, 7, 16, 12, None),       # no presence: ones
    (2, 4, 6, 8, 8, "zero"),       # one set whose presence is all 0
    (2, 9, 13, 10, 6, "soft"),     # N != M, nothing a power of two
    (2, 40, 40, 16, 16, "soft"),   # the flagship's set-attention shape
    (2, 32, 40, 256, 256, "soft"),  # its final attention's
    # presences where the weights follow the scores, not the presences
    (2, 40, 40, 16, 16, "binary"),
    (2, 32, 40, 256, 256, "near one"),  # and the order of mask and scale
])
def test_use_pallas_matches_jax(B, N, M, dk, dv, presence):
    arrays = inputs(B, N, M, dk, dv, presence)
    cot = np.cos(np.arange(B * N * dv, dtype=np.float32)).reshape(B, N, dv)

    def j_loss(*a):
        out = j_attention(*a[:3], a[3] if len(a) > 3 else None,
                          use_pallas=True)
        return jnp.sum(out * cot), out

    # op by op, as the port runs: under jit XLA may reorder the penalty's
    # arithmetic, and d/dpresence carries the 1e9 of the mask
    grads, want = jax.grad(j_loss, argnums=tuple(range(len(arrays))),
                           has_aux=True)(*[jnp.asarray(a) for a in arrays])

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    counted = trace.Since()
    got = qkv_attention(*leaves[:3], leaves[3] if presence else None,
                        use_pallas=True)
    (got * torch.from_numpy(cot)).sum().backward()
    assert counted.launches("K6") == (0,)  # CPU tensors take the plain one
    close(got.detach().numpy(), np.asarray(want), "value")
    for name, leaf, g in zip("qkvp", leaves, grads):
        if name == "p" and presence in SCORED:
            # d/dpresence is 1e9 / sqrt(d_k) times a sum over the queries
            # that cancels to a few ulps of its terms wherever two keys
            # share the weight; hence 1e-5 of its largest |entry|
            err = np.abs(leaf.grad.numpy() - np.asarray(g)).max()
            assert err <= TOL * np.abs(np.asarray(g)).max(), err
            continue
        close(leaf.grad.numpy(), np.asarray(g), f"d{name}")


def test_all_absent_set_gives_uniform_weights():
    """Every key absent: each logit takes the same -1e9 offset, so the
    weights stay finite and uniform, as the reference's do."""
    q, k, v, p = [torch.from_numpy(a) for a in
                  inputs(1, 3, 5, 4, 2, "soft", seed=1)]
    out = qkv_attention(q, k, v, torch.zeros_like(p), use_pallas=True)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand(
        1, 3, 2), rtol=0, atol=1e-6)


def test_function_returns_no_gradient_where_none_is_asked():
    q, k, v, p = [torch.from_numpy(a) for a in inputs(2, 3, 4, 5, 6, "soft")]
    q.requires_grad_()
    out = torch.ops.scae_tpu_torch.attention_fwd(q, k, v, p)
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert k.grad is None and p.grad is None


@pytest.mark.parametrize("n_heads,inducing", [(1, None), (2, None), (2, 3)])
def test_set_transformer_use_pallas_matches_jax(n_heads, inducing):
    """SAB and ISAB blocks, one and two heads (heads folded into the
    batch, presence repeated per head), layer norm on: the flag on both
    sides, on the same flax weights; and the weights carry over unchanged
    (the flag adds no parameters)."""
    args = dict(dim_in=11, dim_hidden=8, dim_out=10, n_outputs=4,
                n_layers=2, n_heads=n_heads, layer_norm=True,
                n_inducing_points=inducing)
    jm = j_st.SetTransformer(**args, use_pallas_attention=True)
    tm = t_st.SetTransformer(**args, use_pallas_attention=True)
    plain = t_st.SetTransformer(**args)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in plain.named_parameters()]
    rng = np.random.RandomState(2)
    x = rng.rand(3, 6, 11).astype(np.float32)
    pres = rng.rand(3, 6).astype(np.float32)
    pres[0, 2] = 0.0
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(pres))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), params)
    load_flax_params(tm, params)
    assert tm.use_pallas_attention
    assert all(m.use_pallas for m in tm.modules()
               if isinstance(m, t_st.MultiHeadQKVAttention))

    def j_loss(p, xx):
        out = jm.apply({"params": p}, xx, jnp.asarray(pres))
        return jnp.sum(out ** 2), out

    (j_gp, j_gx), want = jax.jit(jax.grad(j_loss, argnums=(0, 1),
                                          has_aux=True))(params,
                                                         jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    got = tm(xt, torch.from_numpy(pres))
    (got ** 2).sum().backward()
    close(got.detach().numpy(), np.asarray(want), "value")
    close(xt.grad.numpy(), np.asarray(j_gx), "dx")
    from scae_tpu_torch.utils.from_flax import flax_to_state_dict

    j_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_gp))
    for name, param in tm.named_parameters():
        close(param.grad.numpy(), np.asarray(j_grads[name]), name)
    # the flag set after construction reaches every attention, and off
    # again it gives the einsum path the same values
    plain.load_state_dict(tm.state_dict())
    plain.use_pallas_attention = True
    close(plain(torch.from_numpy(x), torch.from_numpy(pres)).detach().numpy(),
          np.asarray(want), "flag set after construction")


@pytest.mark.parametrize("B,N,M,dk,dv", [(128, 40, 40, 16, 16),
                                         (128, 32, 40, 256, 256)])
@pytest.mark.parametrize("presence", ["ones", "binary", "near one"])
def test_presence_kinds_let_the_scores_show(B, N, M, dk, dv, presence):
    """At the flagship's attention shapes, the kinds of presence that the
    card's checks of K6 use (chip_smoke.py, tests/test_torch_gpu.py) give an
    output that an error in the scores would move far past their 1e-4:
    zeroed scores do, and at the final attention so does scaling before
    masking. Soft presences in [0, 1) do not: their 1e9 penalties are
    apart by far more than any score, and the softmax is one-hot."""
    q, k, v, p = [torch.from_numpy(a)
                  for a in inputs(B, N, M, dk, dv, presence)]
    want = k6.attention_plain(q, k, v, p)

    def mutant(scores, mask_first=True):
        routing = scores - (1.0 - p[:, None, :]) * 1e9 if mask_first \
            else scores / dk ** 0.5 - (1.0 - p[:, None, :]) * 1e9
        if mask_first:
            routing = routing / dk ** 0.5
        return torch.softmax(routing, dim=-1) @ v

    scores = q @ k.transpose(1, 2)
    torch.testing.assert_close(mutant(scores), want, rtol=1e-5, atol=1e-5)
    assert float((mutant(torch.zeros_like(scores)) - want).abs().max()) > 1e-2
    if presence == "near one" and dk == 256:
        moved = float((mutant(scores, mask_first=False) - want).abs().max())
        assert moved > 1e-2
    p_soft = torch.from_numpy(np.asarray(
        np.random.RandomState(0).rand(B, M), np.float32))
    soft = k6.attention_plain(q, k, v, p_soft)
    blind = k6.attention_plain(torch.zeros_like(q), k, v, p_soft)
    assert torch.equal(soft, blind)
