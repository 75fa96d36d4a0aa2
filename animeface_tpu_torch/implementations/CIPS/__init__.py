'''CIPS in PyTorch: the generator, the recipe's models, its training step, its sampler and its CLI.'''

from animeface_tpu_torch.implementations.CIPS.utils import main  # noqa: F401
