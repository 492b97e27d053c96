"""The reference's training step: decode, pad, translate, forward with
noise, the eight-term loss, autograd, RMSprop.

The per-step seeds follow the training job's rule, written out here from
its definition: step ``t`` of a job seeded ``s`` draws its translation
from a generator seeded ``fold_in(s, t, 7)`` and its capsule noise from
one seeded ``fold_in(s, t)`` (SplitMix64 finalisers folded in turn), on
the data's device. The draws come in the forward's order: the
translation's x then y offsets; then the part presences' noise (B, M), the
object capsules' (B, O, 1) and the votes' (B, O, V).
"""

import torch
import torch.nn.functional as F

MASK64 = (1 << 64) - 1


def splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def fold_in(seed, *data):
    for d in data:
        seed = splitmix64(seed ^ splitmix64(d & MASK64))
    return seed & ((1 << 63) - 1)


def decode(raw):
    """uint8 (B, H, W) or (B, H, W, C) -> float32 (B, C, H, W) in [0, 1]."""
    x = raw.to(torch.float32) / 255.0
    return x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)


def pad_to(images, canvas):
    h, w = images.shape[-2:]
    top, left = (canvas - h) // 2, (canvas - w) // 2
    return F.pad(images, (left, canvas - w - left, top, canvas - h - top))


def translate(images, generator, max_shift):
    """Each image's window at offsets drawn in [0, 2 max_shift] of the
    image padded by ``max_shift``."""
    B, C, H, W = images.shape
    kw = dict(generator=generator, device=generator.device)
    ox = torch.randint(0, 2 * max_shift + 1, (B,), **kw)
    oy = torch.randint(0, 2 * max_shift + 1, (B,), **kw)
    padded = F.pad(images, (max_shift,) * 4)
    out = torch.empty_like(images)
    for b in range(B):
        out[b] = padded[b, :, oy[b]:oy[b] + H, ox[b]:ox[b] + W]
    return out


class RMSprop:
    """nu = 0.99 nu + 0.01 g^2; u = -lr g / (sqrt(nu) + eps);
    trace = u + momentum trace; p += trace. The rate decays by
    ``decay_per_epoch`` once an epoch of ``steps_per_epoch`` steps."""

    def __init__(self, params, lr, eps, momentum, decay_per_epoch,
                 steps_per_epoch):
        self.params = list(params)
        self.lr, self.eps, self.momentum = lr, eps, momentum
        self.decay, self.spe = decay_per_epoch, steps_per_epoch
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.lr * self.decay ** (self.count // self.spe)
        self.count += 1
        for p, g, nu, tr in zip(self.params, grads, self.nu, self.trace):
            nu.mul_(0.99).add_(0.01 * g * g)
            tr.mul_(self.momentum).add_(-lr * g / (torch.sqrt(nu) + self.eps))
            p.add_(tr)


def train_step(model, opt, raw, labels, job_seed, step, canvas, max_shift,
               half_batch=False):
    """One step; returns (loss terms and loss as floats, gradients).
    ``half_batch``: the step on the first half of the rows only (a fault
    the comparison must catch)."""
    if half_batch:
        raw, labels = raw[:raw.shape[0] // 2], labels[:labels.shape[0] // 2]
    device = raw.device
    images = pad_to(decode(raw), canvas)
    aug = torch.Generator(device=device).manual_seed(fold_in(job_seed, step,
                                                             7))
    images = translate(images, aug, max_shift)
    noise = torch.Generator(device=device).manual_seed(fold_in(job_seed,
                                                               step))
    out = model(images, generator=noise)
    loss, terms = model.loss(out, labels)
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(opt.params, grads)]
    opt.step(grads)
    values = {k: float(v.detach()) for k, v in terms.items()}
    values["loss"] = float(loss.detach())
    return values, grads


@torch.no_grad()
def eval_losses(model, raw, labels, canvas):
    """The deterministic forward's loss of one batch."""
    loss, _ = model.loss(model(pad_to(decode(raw), canvas)), labels)
    return float(loss)
