'''NAFNet in PyTorch: the gated UNet G, the patch D, the restoration step and its CLI.'''

from animeface_tpu_torch.implementations.NAFNet.utils import main  # noqa: F401
