"""The plain FFR-Net training step (haoosz/FFR-Net run.py): the frozen
encoder on the clean and the masked faces, RecNet trained on both
branches, the four-part objective, its gradient clipped elementwise at
`clip`, and Adam with L2 weight decay into the clipped gradient.

Objective (loss weights w0..w3):
  0  self-similarity: mean of the MSEs between the clean frozen map's
     position and channel Grams and those of each branch's feat_space and
     feat_channel_m (spatial and channel averaged)
  1  triplet, cosine distance, margin 0.1: anchor the masked branch's
     feat_new_v, positive the clean frozen embedding, negative the masked one
  2  identity: MSE of both branches' feat_new_v against the clean embedding
  3  CosFace cross-entropy of both branches, the clean term divided by
     (1e-8 + w3) (the reference's weighting)

Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), with lr the base
rate times lr_gamma for each milestone the update count before the step
has reached. A Trainer starts from zero moments at count 0, or from a
given state (`moments`, `count`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmarks.reference import irse, recnet


def mse(a, b):
    return torch.mean(torch.square(a - b))


def _l2(x, eps=1e-12):
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)).clamp_min(eps)


def objective(featmap_non, embed_non, embed_ocl, out_non, out_ocl, logits_non, logits_ocl,
              labels, w=(1.0, 1.0, 1.0, 1.0)):
    n = featmap_non.shape[0]

    def space(x):
        return recnet.cosine_gram(x.reshape(n, recnet.C, -1).transpose(1, 2))

    def channel(x):
        return recnet.cosine_gram(x.reshape(n, recnet.C, -1))

    ss_space, ss_channel = space(featmap_non), channel(featmap_non)
    l_space = (mse(ss_space, space(out_non["feat_space"]))
               + mse(ss_space, space(out_ocl["feat_space"]))) / 2
    l_channel = (mse(ss_channel, channel(out_non["feat_channel_m"]))
                 + mse(ss_channel, channel(out_ocl["feat_channel_m"]))) / 2
    item0 = (l_space + l_channel) / 2
    a = _l2(out_ocl["feat_new_v"])
    pos_d = 1.0 - torch.sum(a * _l2(embed_non), dim=1)
    neg_d = 1.0 - torch.sum(a * _l2(embed_ocl), dim=1)
    item1 = torch.mean(torch.clamp_min(pos_d - neg_d + 0.1, 0))
    item2 = (mse(out_non["feat_new_v"], embed_non) + mse(out_ocl["feat_new_v"], embed_non)) / 2
    item3 = (F.cross_entropy(logits_non, labels) / (1e-8 + w[3])
             + F.cross_entropy(logits_ocl, labels))
    return item0 * w[0] + item1 * w[1] + item2 * w[2] + item3 * w[3]


class Trainer:
    """RecNet's parameters, running statistics and Adam moments, trained
    from the frozen encoder's features of each batch."""

    def __init__(self, enc_params, rec_params, hp, moments=None, count=0):
        self.enc = enc_params
        self.params = {k: v for k, v in rec_params.items() if not recnet.is_buffer(k)}
        self.buffers = {k: v for k, v in rec_params.items() if recnet.is_buffer(k)}
        self.hp = hp
        if moments is None:
            moments = ({k: torch.zeros_like(v) for k, v in self.params.items()},
                       {k: torch.zeros_like(v) for k, v in self.params.items()})
        self.m, self.v = moments
        self.t = count
        self.losses, self.first_grad, self.first_grad_raw = [], None, None

    def lr(self) -> float:
        hp = self.hp
        return hp["lr"] * hp["lr_gamma"] ** sum(m <= self.t for m in hp["milestones"])

    @torch.no_grad()
    def features(self, x_non, x_ocl, num):
        fm, emb = irse.forward(self.enc, torch.cat([x_non, x_ocl]), num)
        n = x_non.shape[0]
        return fm[:n], fm[n:], emb[:n], emb[n:]

    def step(self, x_non, x_ocl, labels, num):
        """One update from NCHW [-1, 1] faces; returns the loss."""
        hp = self.hp
        fm_non, fm_ocl, emb_non, emb_ocl = self.features(x_non, x_ocl, num)
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        p = {**leaves, **self.buffers}
        out_non = recnet.forward(p, fm_non, num, train=True)
        out_ocl = recnet.forward(p, fm_ocl, num, train=True)
        cls = p["classifier.weight"]
        kw = dict(s=hp["s"], m=hp["m"])
        loss = objective(fm_non, emb_non, emb_ocl, out_non, out_ocl,
                         recnet.cosface_logits(cls, out_non["feat_new_v"], labels, **kw),
                         recnet.cosface_logits(cls, out_ocl["feat_new_v"], labels, **kw),
                         labels, hp["loss_weight"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        lr = self.lr()
        self.t += 1
        b1, b2 = hp["betas"]
        with torch.no_grad():
            given, clipped = {}, {}
            for (k, p0), g in zip(self.params.items(), grads):
                clipped[k] = g = g.clamp(-hp["clip"], hp["clip"])
                g = g + hp["weight_decay"] * p0
                given[k] = g
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                self.params[k] = p0 - lr * m_hat / (torch.sqrt(v_hat) + hp["eps"])
        if self.first_grad is None:
            self.first_grad, self.first_grad_raw = given, clipped
        self.losses.append(float(loss.detach()))
        return self.losses[-1]
