'''Adversarial losses on discriminator logits (counterpart of
`animeface_tpu/nnutils/loss/gan.py`): the same formulas, each a mean over
all elements.'''

from __future__ import annotations

import torch
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


def _bce_with_logits(logits, target):
    return (F.softplus(logits) - logits * target).mean()


class GANLoss(Adversarial):
    '''original GAN: BCE-with-logits to 1 (real) / 0 (fake).'''

    def real_loss(self, prob):
        return _bce_with_logits(prob, torch.ones_like(prob))

    def fake_loss(self, prob):
        return _bce_with_logits(prob, torch.zeros_like(prob))


class LSGANLoss(Adversarial):
    '''least squares GAN (a,b,c = 0,1,1): 0.5 * MSE terms.'''

    def real_loss(self, prob):
        return ((prob - 1.0) ** 2).mean()

    def fake_loss(self, prob):
        return (prob ** 2).mean()

    def d_loss(self, real_prob, fake_prob):
        rl = self.real_loss(real_prob) * 0.5
        fl = self.fake_loss(fake_prob) * 0.5
        loss = rl + fl
        if self.return_all:
            return loss, rl, fl
        return loss

    def g_loss(self, fake_prob):
        return self.real_loss(fake_prob) * 0.5


class NonSaturatingLoss(Adversarial):
    '''softplus(-D(x)) + softplus(D(G(z))); G: softplus(-D(G(z))).'''

    def real_loss(self, prob):
        return F.softplus(-prob).mean()

    def fake_loss(self, prob):
        return F.softplus(prob).mean()


class WGANLoss(Adversarial):
    '''Wasserstein: D maximises E[D(x)] - E[D(G(z))].'''

    def real_loss(self, prob):
        return -prob.mean()

    def fake_loss(self, prob):
        return prob.mean()


class HingeLoss(Adversarial):
    '''hinge: relu(1-D(x)) + relu(1+D(G(z))); G: -E[D(G(z))].'''

    def real_loss(self, prob):
        return F.relu(1.0 - prob).mean()

    def fake_loss(self, prob):
        return F.relu(1.0 + prob).mean()

    def g_loss(self, fake_prob):
        return -fake_prob.mean()
