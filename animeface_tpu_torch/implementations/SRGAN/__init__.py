'''SRGAN in PyTorch: the residual G with pixel shuffle, the multi-scale D, the recipe's step and its CLI.'''

from animeface_tpu_torch.implementations.SRGAN.utils import main  # noqa: F401
