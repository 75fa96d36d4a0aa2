'''FID, KID and the random-VGG trend metric (counterpart of
`animeface_tpu/metrics`).'''

from animeface_tpu_torch.metrics.fid import (  # noqa: F401
    gaussian_statistics, frechet_distance, compute_fid, compute_kid,
    FeatureAccumulator,
)
from animeface_tpu_torch.metrics.inception import (  # noqa: F401
    InceptionV3Features, load_inception_params, inception_available,
    make_extractor,
)
