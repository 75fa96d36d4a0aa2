'''ESRGAN in PyTorch: the RRDB G on SRGAN's D, the relativistic step and its CLI.'''

from animeface_tpu_torch.implementations.ESRGAN.utils import main  # noqa: F401
