"""Model FLOPs of one image, counted from a configuration's shapes.

Independent of the implementation: 2 x the multiply-adds of every
convolution and matrix product of the forward (the encoder's convolutions
and its 1x1 attention convolution, the template colour MLP, the set
transformer's projections and attention products, the capsule MLP banks
and the two classifier heads). Elementwise work, the bilinear warps and
the mixture likelihoods are not counted here: the likelihood kernels
have their own roofline (``roofline.py``). A training step counts 3 x the
forward (the backward's two products per forward product).
"""


def conv_out(size, k, s):
    return (size - k) // s + 1


def forward_macs(model):
    """Multiply-adds of one image's forward, from a configuration's
    ``model`` entry (factory defaults for what it leaves out)."""
    C, H, W = model["image_shape"]
    M, O = model["n_part_caps"], model["n_obj_caps"]
    enc = model.get("pcae_cnn_encoder_params") or {}
    tg = model.get("pcae_template_generator_params") or {}
    st = model.get("ocae_encoder_set_transformer_params") or {}
    caps = model.get("ocae_decoder_capsule_params") or {}
    chans = enc.get("out_channels", (128, 128, 128, 128))
    ks = enc.get("kernel_sizes", (3, 3, 3, 3))
    strides = enc.get("strides", (2, 2, 1, 1))
    Ht, Wt = tg.get("template_size", (11, 11))
    n_layers = st.get("n_layers", 3)
    dh, do = st.get("dim_hidden", 16), st.get("dim_out", 256)
    dim_caps = caps.get("dim_caps", 32)
    hidden = list(caps.get("hidden_sizes", (128,)))
    P, S = 6, 16

    macs, h, w, c = 0, H, W, C
    for co, k, s in zip(chans, ks, strides):
        h, w = conv_out(h, k, s), conv_out(w, k, s)
        macs += h * w * co * c * k * k
        c = co
    macs += h * w * c * M * (P + 1 + S + 1)               # 1x1 attention conv
    macs += M * (S * 32 + 32 * C)                         # colour MLP
    dim_in = P + S + 1 + C * Ht * Wt
    macs += M * dim_in * dh                               # fc1
    macs += n_layers * (M * dh * 3 * dh                   # qkv
                        + 2 * M * M * dh                  # QK^T, AV
                        + 2 * M * dh * dh)                # o, fc
    macs += M * dh * do                                   # fc2
    macs += (O * do * do + M * do * 2 * do                # q, kv
             + 2 * O * M * do + O * do * do)              # QK^T, AV, o
    sizes = [do, *hidden, dim_caps]
    macs += O * sum(a * b for a, b in zip(sizes, sizes[1:]))
    out = M * 6 + 6 + 1 + M + M
    sizes = [dim_caps + 1, *hidden, out]
    macs += O * sum(a * b for a, b in zip(sizes, sizes[1:]))
    macs += 2 * O * model["n_classes"]                    # classifier heads
    return macs


def forward_flops(model):
    return 2 * forward_macs(model)


def train_flops(model):
    return 3 * forward_flops(model)
