"""The plain float32 SCAE: the reference that decides ``correct``.

A frozen copy of the stacked capsule autoencoder's equations (Kosiorek et
al. 2019) in plain PyTorch operations, with the parameter names and layouts
of ``scae_tpu_torch``'s model, so that one state dict loads into both. It
imports nothing of ``scae_tpu_torch``, runs no kernel of its own and no CUDA
graph, and is computed with TF32 off (``reference.math_mode``).

Where it departs from the port's plain path:

* the image likelihood renders the M warped templates and the background
  as a per-pixel Gaussian mixture (dense bilinear tap matrices, then
  ``logsumexp``) and differentiates it by autograd; the port takes the
  fused likelihood (the gather kernels K1 and K2+K3 at 11x11 templates,
  whose backward has its own slope at texel centres and edges, where a
  bilinear weight has a kink);
* attention is the einsum form, never the K6 kernel;
* no mesh: every batch is one process's whole batch;
* only the pieces the benchmark's configurations use: enc votes and
  presences, no capsule dropout, uniform noise, alpha-channel templates,
  no reconstruct-alternatives renders.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
LOG_001 = math.log(0.01)
MASK = 1e9


def log_safe(x, eps=1e-16):
    small = x < eps
    return torch.where(small, torch.full_like(x, -1e8),
                       torch.log(torch.where(small, torch.ones_like(x), x)))


def geometric_transform(pose):
    """(scale_x, scale_y, theta, shear, tx, ty) -> flat 2x3 affine."""
    sx, sy, th, sh, tx, ty = torch.split(pose, 1, dim=-1)
    sx, sy = torch.sigmoid(sx) + 1e-2, torch.sigmoid(sy) + 1e-2
    tx, ty, sh = torch.tanh(tx * 5.0), torch.tanh(ty * 5.0), torch.tanh(sh * 5.0)
    th = th * (2.0 * math.pi)
    c, s = torch.cos(th), torch.sin(th)
    return torch.cat([sx * c + sh * sy * s, -sx * s + sh * sy * c, tx,
                      sy * s, sy * c, ty], dim=-1)


def compose_affines(outer, inner):
    a1, b1, tx1, c1, d1, ty1 = torch.split(outer, 1, dim=-1)
    a2, b2, tx2, c2, d2, ty2 = torch.split(inner, 1, dim=-1)
    return torch.cat([a1 * a2 + b1 * c2, a1 * b2 + b1 * d2,
                      a1 * tx2 + b1 * ty2 + tx1, c1 * a2 + d1 * c2,
                      c1 * b2 + d1 * d2, c1 * tx2 + d1 * ty2 + ty1], dim=-1)


def axis(n, dtype, device):
    """Pixel centres (2j + 1)/n - 1, the quotient rounded once from
    float64 (IEEE division's result on every device)."""
    q = (2.0 * torch.arange(n, dtype=torch.float64, device=device) + 1.0) / n
    return q.to(dtype) - 1.0


def source_coordinates(pose, template_size, out_size):
    """Each output pixel's (ix, iy) in template pixels, [..., H*W] each,
    as ``F.affine_grid`` / ``F.grid_sample`` with align_corners=False."""
    Ht, Wt = template_size
    H, W = out_size
    gx = axis(W, pose.dtype, pose.device)[None, :].expand(H, W).reshape(-1)
    gy = axis(H, pose.dtype, pose.device)[:, None].expand(H, W).reshape(-1)
    a, b, tx, c, d, ty = [pose[..., i, None] for i in range(6)]
    ix = ((a * gx + b * gy + tx + 1.0) * Wt - 1.0) * 0.5
    iy = ((c * gx + d * gy + ty + 1.0) * Ht - 1.0) * 0.5
    return ix, iy


def affine_warp(templates, pose, out_size):
    """Bilinear warp of [..., C, Ht, Wt] templates by [..., 6] poses onto
    an (H, W) canvas, zero outside the template."""
    *lead, C, Ht, Wt = templates.shape
    ix, iy = source_coordinates(pose, (Ht, Wt), out_size)
    cols = torch.arange(Wt, dtype=pose.dtype, device=pose.device)[:, None]
    rows = torch.arange(Ht, dtype=pose.dtype, device=pose.device)[:, None]
    wx = torch.relu(1.0 - torch.abs(ix[..., None, :] - cols))
    wy = torch.relu(1.0 - torch.abs(iy[..., None, :] - rows))
    s = torch.einsum("...chw,...wp->...chp", templates, wx)
    out = torch.einsum("...chp,...hp->...cp", s, wy)
    return out.reshape(*lead, C, *out_size)


class Linear(nn.Module):
    """y = x W^T + b, W (out, in). ``exact``: a multiply-and-sum, never a
    library product (the classifier heads)."""

    def __init__(self, n_in, n_out, bias=True, exact=False):
        super().__init__()
        self.exact = exact
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        if self.exact:
            y = torch.sum(x[..., :, None] * self.weight.t(), dim=-2)
            return y if self.bias is None else y + self.bias
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, c_in, c_out, k, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class Seq(nn.Module):
    """Layers ``<prefix>_0, <prefix>_1, ...``, relu between them and after
    the last."""

    def __init__(self, prefix, layers):
        super().__init__()
        self.prefix, self.n = prefix, len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"{prefix}_{i}", layer)

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"{self.prefix}_{i}")(x))
        return x


class StackedMLP(nn.Module):
    """O independent MLPs on (..., O, in); kernels (O, in, out)."""

    def __init__(self, n, sizes, bias=True):
        super().__init__()
        self.n_layers, self.has_bias = len(sizes) - 1, bias
        for j in range(self.n_layers):
            self.register_parameter(f"kernel_{j}", nn.Parameter(
                torch.empty(n, sizes[j], sizes[j + 1])))
            if bias:
                self.register_parameter(f"bias_{j}", nn.Parameter(
                    torch.empty(n, sizes[j + 1])))

    def forward(self, x):
        lead, O = x.shape[:-2], x.shape[-2]
        h = x.reshape(-1, O, x.shape[-1]).transpose(0, 1)
        for j in range(self.n_layers):
            h = torch.bmm(h, getattr(self, f"kernel_{j}"))
            if self.has_bias:
                h = h + getattr(self, f"bias_{j}")[:, None, :]
            h = F.relu(h)
        return h.transpose(0, 1).reshape(*lead, O, h.shape[-1])


def attention(q, k, v, presence):
    """softmax((Q K^T - (1 - presence) 1e9) / sqrt(d)) V, one head."""
    routing = torch.einsum("bnd,bmd->bnm", q, k)
    if presence is not None:
        routing = routing - (1.0 - presence[:, None, :]) * MASK
    routing = torch.softmax(routing / math.sqrt(q.shape[-1]), dim=-1)
    return torch.einsum("bnm,bmv->bnv", routing, v)


class Attention(nn.Module):
    """One-head attention: q, k, v from one projection (self) or q from
    the queries and k, v from the keys."""

    def __init__(self, d_q, d_kv, d, self_attention):
        super().__init__()
        self.d, self.self_attention = d, self_attention
        if self_attention:
            self.qkv_projector = Linear(d_q, 3 * d)
        else:
            self.q_projector = Linear(d_q, d)
            self.kv_projector = Linear(d_kv, 2 * d)
        self.o_projector = Linear(d, d)

    def forward(self, queries, keys, presence):
        d = self.d
        if self.self_attention:
            q, k, v = torch.split(self.qkv_projector(queries), d, dim=-1)
        else:
            q = self.q_projector(queries)
            k, v = torch.split(self.kv_projector(keys), d, dim=-1)
        return self.o_projector(attention(q, k, v, presence))


class MAB(nn.Module):
    def __init__(self, d, self_attention):
        super().__init__()
        self.mqkv = Attention(d, d, d, self_attention)
        self.ln0 = nn.LayerNorm(d, eps=1e-5)
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.fc = Linear(d, d)

    def forward(self, queries, keys, presence):
        h = self.mqkv(queries, keys, presence) + queries
        if presence.shape[1] == queries.shape[1]:
            h = h * presence[..., None]
        h = self.ln0(h)
        return self.ln1(h + F.relu(self.fc(h)))


class SAB(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.mab = MAB(d, self_attention=True)

    def forward(self, x, presence):
        return self.mab(x, x, presence)


class Model(nn.Module):
    """The SCAE of a configuration's ``model`` entry (the keyword
    arguments of the port's ``prepare_model_config``, factory defaults
    for what it leaves out)."""

    def __init__(self, cfg):
        super().__init__()
        C, H, W = cfg["image_shape"]
        M, O = cfg["n_part_caps"], cfg["n_obj_caps"]
        enc = cfg.get("pcae_cnn_encoder_params") or {}
        chans = enc.get("out_channels", (128, 128, 128, 128))
        ks = enc.get("kernel_sizes", (3, 3, 3, 3))
        strides = enc.get("strides", (2, 2, 1, 1))
        dec = cfg.get("pcae_decoder_params") or {}
        tg = cfg.get("pcae_template_generator_params") or {}
        st = cfg.get("ocae_encoder_set_transformer_params") or {}
        caps = cfg.get("ocae_decoder_capsule_params") or {}
        self.C, self.H, self.W, self.M, self.O = C, H, W, M, O
        self.P, self.S = 6, 16
        self.Ht, self.Wt = tg.get("template_size", (11, 11))
        self.noise_scale = 4.0
        self.learn_output_scale = dec.get("learn_output_scale", False)
        self.n_classes = cfg["n_classes"]
        self.n_layers = st.get("n_layers", 3)
        dh, do = st.get("dim_hidden", 16), st.get("dim_out", 256)
        dim_caps = caps.get("dim_caps", 32)
        hidden = tuple(caps.get("hidden_sizes", (128,)))

        convs, h, c = [], H, C
        for co, k, s in zip(chans, ks, strides):
            convs.append(Conv(c, co, k, s))
            h, c = (h - k) // s + 1, co
        self.part_encoder = nn.Module()
        self.part_encoder.encoder = nn.Module()
        self.part_encoder.encoder.network = Seq("conv", convs)
        self.part_encoder.img_embedding_bias = nn.Parameter(
            torch.empty(c, h, h))
        self.part_encoder.att_conv = Conv(c, M * (self.P + 1 + self.S + 1), 1)

        self.template_generator = nn.Module()
        self.template_generator.template_logits = nn.Parameter(
            torch.empty(1, M, C, self.Ht, self.Wt))
        self.template_generator.templates_color_mlp = Seq(
            "linear", [Linear(self.S, 32), Linear(32, C)])

        self.part_decoder = nn.Module()
        self.part_decoder.bg_value = nn.Parameter(torch.empty(1))
        self.part_decoder.templates_alpha = nn.Parameter(
            torch.empty(1, M, 1, self.Ht, self.Wt))
        self.part_decoder.bg_mixing_logit = nn.Parameter(torch.empty(1))
        if self.learn_output_scale:
            self.part_decoder.scale = nn.Parameter(torch.empty(1))

        dim_in = self.P + self.S + 1 + C * self.Ht * self.Wt
        self.obj_encoder = nn.Module()
        self.obj_encoder.fc1 = Linear(dim_in, dh)
        for i in range(self.n_layers):
            self.obj_encoder.add_module(f"sab_{i}", SAB(dh))
        self.obj_encoder.fc2 = Linear(dh, do)
        self.obj_encoder.seeds = nn.Parameter(torch.empty(1, O, do))
        self.obj_encoder.multi_head_attention = Attention(do, do, do, False)

        V = M
        self.splits = [V * 6, 6, 1, V, V]
        layer = nn.Module()
        layer.mlps = StackedMLP(O, (do, *hidden, dim_caps))
        layer.caps_mlps = StackedMLP(O, (dim_caps + 1, *hidden,
                                         sum(self.splits)), bias=False)
        layer.cpr_static = nn.Parameter(torch.empty(1, O, V, 6))
        for i, s in enumerate([(1, 6), (1,), (V,), (V,)]):
            layer.register_parameter(f"caps_bias_{i}",
                                     nn.Parameter(torch.empty(1, O, *s)))
        self.obj_decoder = nn.Module()
        self.obj_decoder.capsule_layer = layer
        self.obj_decoder.dummy_vote = nn.Parameter(torch.empty(1, 1, V, 6))
        self.prior_classifier = Linear(O, self.n_classes, exact=True)
        self.posterior_classifier = Linear(O, self.n_classes, exact=True)

    # ------------------------------------------------------------ forward

    def forward(self, image, generator=None):
        """image (B, C, H, W) -> dict of the forward's tensors; noise from
        ``generator`` where given (a training step), none otherwise."""
        B, M, O, P, S = image.shape[0], self.M, self.O, self.P, self.S
        pe = self.part_encoder
        h = pe.encoder.network(image) + pe.img_embedding_bias[None]
        h = pe.att_conv(h)
        G = h.shape[-1] * h.shape[-2]
        h = h.reshape(B, M, P + 1 + S + 1, G)
        att = torch.softmax(h[:, :, -1:], dim=-1)
        h = torch.sum(h[:, :, :-1] * att, dim=-1)           # (B, M, P+1+S)
        pose_raw, presence_logit, feature = (h[..., :P], h[..., P],
                                             h[..., P + 1:])
        if generator is not None:
            u = torch.rand((B, M), generator=generator, dtype=h.dtype,
                           device=h.device)
            presence_logit = presence_logit + (u - 0.5) * self.noise_scale
        presence = torch.sigmoid(presence_logit)
        pose = geometric_transform(pose_raw)

        tg = self.template_generator
        raw_templates = torch.sigmoid(tg.template_logits)
        color = torch.sigmoid(tg.templates_color_mlp(feature))
        templates = raw_templates * color[:, :, :, None, None]

        # object capsules, on detached part capsules
        parts = torch.cat([pose.detach(), 1.0 - presence.detach()[..., None],
                           feature, templates.detach().reshape(B, M, -1)],
                          dim=-1)
        x = self.obj_encoder.fc1(parts)
        pres = presence.detach()
        for i in range(self.n_layers):
            x = getattr(self.obj_encoder, f"sab_{i}")(x, pres)
        z = self.obj_encoder.fc2(x)
        seeds = self.obj_encoder.seeds.expand(B, -1, -1)
        encoding = self.obj_encoder.multi_head_attention(seeds, z, pres)

        caps = self._capsules(encoding, pose.detach(), pres, generator)
        return {"pose": pose, "presence": presence, "templates": templates,
                "image": image, **caps}

    def _capsules(self, encoding, part_pose, part_presence, generator):
        layer = self.obj_decoder.capsule_layer
        B, O, V = encoding.shape[0], self.O, self.M
        raw = layer.mlps(encoding)
        allp = layer.caps_mlps(torch.cat([raw, torch.ones_like(raw[..., :1])],
                                         dim=-1))
        shapes = [(V, 6), (1, 6), (1,), (V,), (V,)]
        chunks = [c.reshape(B, O, *s) for c, s in
                  zip(torch.split(allp, self.splits, dim=-1), shapes)]
        cpr_dynamic = chunks[0]
        cpr_reg = torch.sum(cpr_dynamic * cpr_dynamic) / 2 / B
        cpr = geometric_transform(cpr_dynamic + layer.cpr_static)
        cvr = geometric_transform(chunks[1] + layer.caps_bias_0)
        logit_caps = chunks[2] + layer.caps_bias_1
        logit_vote = chunks[3] + layer.caps_bias_2
        scale = F.softplus(chunks[4] + layer.caps_bias_3 + 0.5) + 1e-2
        vote = compose_affines(cvr, cpr)                      # (B, O, V, 6)
        if generator is not None:
            for name, t in (("caps", logit_caps), ("vote", logit_vote)):
                u = torch.rand(t.shape, generator=generator, dtype=t.dtype,
                               device=t.device)
                t = t + (u - 0.5) * self.noise_scale
                if name == "caps":
                    logit_caps = t
                else:
                    logit_vote = t
        vote_presence = torch.sigmoid(logit_caps) * torch.sigmoid(logit_vote)
        caps_presence = torch.amax(vote_presence, dim=-1)

        # capsule likelihood of the part poses
        lp = -((part_pose[:, None] - vote) ** 2) / (
            2.0 * scale[..., None] ** 2) - torch.log(scale[..., None]) \
            - LOG_SQRT_2PI
        vote_lp = torch.sum(lp, dim=-1)                       # (B, O, V)
        const = torch.full((B, 1, V), LOG_001, dtype=vote_lp.dtype,
                           device=vote_lp.device)
        vote_lp = torch.cat([vote_lp, const], dim=1)
        mixing = torch.cat([log_safe(vote_presence), const], dim=1)
        posterior = mixing + vote_lp
        per_point = torch.logsumexp(posterior, dim=1) * part_presence
        log_prob = torch.mean(torch.sum(per_point, dim=1))
        post_mix = torch.softmax(posterior, dim=1)[:, :-1]
        mass = torch.sum(post_mix, dim=-1)
        prior_logit = self.prior_classifier(caps_presence.detach())
        posterior_logit = self.posterior_classifier(mass.detach())
        return {"caps_presence": caps_presence, "log_prob": log_prob,
                "cpr_reg": cpr_reg, "post_mix": post_mix,
                "prior_logit": prior_logit,
                "posterior_logit": posterior_logit}

    # --------------------------------------------------------------- loss

    def image_ll(self, out):
        """Per-pixel mixture log-likelihood of the image, (B, C, H, W)."""
        pdec = self.part_decoder
        pose, presence, templates = out["pose"], out["presence"], \
            out["templates"]
        image = out["image"]
        B, M, C = templates.shape[:3]
        H, W = self.H, self.W
        alpha = pdec.templates_alpha.expand(B, M, 1, self.Ht, self.Wt)
        loc = torch.cat([affine_warp(templates, pose, (H, W)),
                         torch.sigmoid(pdec.bg_value)[0].expand(
                             B, 1, C, H, W)], dim=1)       # (B, M+1, C, H, W)
        mixing = torch.cat([affine_warp(alpha, pose, (H, W)),
                            F.softplus(pdec.bg_mixing_logit)[0].expand(
                                B, 1, 1, H, W)], dim=1)
        full = torch.cat([presence, torch.ones_like(presence[:, :1])], dim=1)
        mixing = mixing + log_safe(full)[:, :, None, None, None]
        if self.learn_output_scale:
            scale = F.softplus(pdec.scale) + 1e-4
        else:
            scale = torch.ones(1, dtype=image.dtype, device=image.device)
        lp = -((image[:, None] - loc) ** 2) / (2.0 * scale * scale) \
            - torch.log(scale) - LOG_SQRT_2PI
        return torch.logsumexp(lp + F.log_softmax(mixing, dim=1), dim=1)

    def loss(self, out, labels):
        """(loss, terms): the eight-term SCAE loss with the shipped
        weights (caps_ll 1, cpr 10, prior l2 2 / 0.35, posterior entropy
        0.7 / 0.2, both classifiers' cross-entropy)."""
        B = labels.shape[0]
        terms = {}
        terms["rec_ll_loss"] = -torch.mean(torch.sum(
            self.image_ll(out).reshape(B, -1), dim=-1))
        terms["log_prob_loss"] = -out["log_prob"]
        caps = out["caps_presence"]
        k = self.n_classes
        terms["prior_within_sparsity_loss"] = torch.mean(
            (torch.sum(caps, 1) - float(self.O) / k) ** 2)
        terms["prior_between_sparsity_loss"] = torch.mean(
            (torch.sum(caps, 0) - float(B) / k) ** 2)
        mass = torch.sum(out["post_mix"], dim=-1) / self.M

        def xent(p):
            return torch.mean(-torch.sum(p * log_safe(p), dim=-1))

        within = mass / (torch.sum(mass, 1, keepdim=True) + 1e-8)
        col = torch.sum(mass, 0)
        between = col / (torch.sum(col) + 1e-8)
        terms["posterior_within_sparsity_loss"] = xent(within)
        terms["posterior_between_sparsity_loss"] = -xent(between)
        terms["cpr_dynamic_reg_loss"] = out["cpr_reg"]
        terms["prior_cls_xe"] = F.cross_entropy(out["prior_logit"], labels)
        terms["posterior_cls_xe"] = F.cross_entropy(out["posterior_logit"],
                                                    labels)
        loss = (terms["rec_ll_loss"] + terms["log_prob_loss"]
                + 2.0 * terms["prior_within_sparsity_loss"]
                + 0.35 * terms["prior_between_sparsity_loss"]
                + 0.7 * terms["posterior_within_sparsity_loss"]
                + 0.2 * terms["posterior_between_sparsity_loss"]
                + 10.0 * terms["cpr_dynamic_reg_loss"]
                + terms["prior_cls_xe"] + terms["posterior_cls_xe"])
        return loss, terms

    def serve(self, image):
        """The serving outputs of a deterministic forward."""
        out = self(image)
        prior = torch.softmax(out["prior_logit"], dim=-1)
        posterior = torch.softmax(out["posterior_logit"], dim=-1)
        return {"part_presence": out["presence"], "part_pose": out["pose"],
                "caps_presence": out["caps_presence"],
                "prior_cls_prob": prior, "posterior_cls_prob": posterior}
