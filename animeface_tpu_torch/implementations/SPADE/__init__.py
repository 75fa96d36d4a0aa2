'''SPADE in PyTorch: the SPADE generator, its VAE encoder, the hinge step
over SRGAN's multi-scale D and its CLI.'''

from animeface_tpu_torch.implementations.SPADE.utils import main  # noqa: F401
