'''Loss base class (counterpart of `animeface_tpu/nnutils/loss/_base.py`).'''


class Loss:
    def __init__(self, return_all: bool = False) -> None:
        self.return_all = return_all
