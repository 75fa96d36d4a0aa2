'''The normalizations ablation in PyTorch: LIN, PoLIN, bn, in and ln in a
reference-based colorization G, and its CLI.'''

from animeface_tpu_torch.implementations.normalizations.utils import main  # noqa: F401
