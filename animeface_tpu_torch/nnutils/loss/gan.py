'''Adversarial losses on discriminator logits (counterpart of
`animeface_tpu/nnutils/loss/gan.py`; this slice ports the non-saturating
loss that StyleGAN2 trains with).'''

from __future__ import annotations

import torch.nn.functional as F

from animeface_tpu_torch.nnutils.loss._base import Loss


class Adversarial(Loss):
    def real_loss(self, prob):
        raise NotImplementedError()

    def fake_loss(self, prob):
        raise NotImplementedError()

    def d_loss(self, real_prob, fake_prob):
        rl = self.real_loss(real_prob)
        fl = self.fake_loss(fake_prob)
        loss = rl + fl
        if self.return_all:
            return loss, rl, fl
        return loss

    def g_loss(self, fake_prob):
        return self.real_loss(fake_prob)


class NonSaturatingLoss(Adversarial):
    '''softplus(-D(x)) + softplus(D(G(z))); G: softplus(-D(G(z))).'''

    def real_loss(self, prob):
        return F.softplus(-prob).mean()

    def fake_loss(self, prob):
        return F.softplus(prob).mean()
