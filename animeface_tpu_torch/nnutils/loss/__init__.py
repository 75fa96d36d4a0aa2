'''Losses of the PyTorch port (counterpart of animeface_tpu.nnutils.loss).'''

from animeface_tpu_torch.nnutils.loss.gan import Adversarial, NonSaturatingLoss  # noqa: F401
from animeface_tpu_torch.nnutils.loss.penalty import r1_regularizer  # noqa: F401
