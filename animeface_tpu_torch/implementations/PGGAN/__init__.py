'''PGGAN in PyTorch: the progressive-growing model, its phase machine and
training step, and the recipe's CLI.'''

from animeface_tpu_torch.implementations.PGGAN.utils import main  # noqa: F401
