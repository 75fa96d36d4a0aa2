'''Losses of the PyTorch port (counterpart of animeface_tpu.nnutils.loss).'''

from animeface_tpu_torch.nnutils.loss.gan import (  # noqa: F401
    Adversarial, GANLoss, HingeLoss, LSGANLoss, NonSaturatingLoss, WGANLoss)
from animeface_tpu_torch.nnutils.loss.penalty import (  # noqa: F401
    gradient_penalty, r1_regularizer)
