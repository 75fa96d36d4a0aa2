'''SEBigGAN in PyTorch: BigGAN with squeeze-and-excitation gating, orthogonal init and the ICR step, with its CLI.'''

from animeface_tpu_torch.implementations.SEBigGAN.utils import main  # noqa: F401
