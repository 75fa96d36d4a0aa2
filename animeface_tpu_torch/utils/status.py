'''Training status: losses, progress bar, log file and loss plot.

Counterpart of `animeface_tpu/utils/status.py` (`Status.update`,
`loss_tail`, `state_dict`, `load_state_dict`, `plot_loss`, the log file).
`update` takes python floats or 0-dim tensors and keeps tensors as they
are: a device value is read (a host sync) only when a bar or a log line
shows it, or by `loss_tail`, `state_dict` and `plot_loss`. `tqdm` and
`matplotlib` are imported when used; without them there is no bar, or no
loss plot, and one warning.
'''

from __future__ import annotations

import datetime
import logging
import time
import warnings


def _tofloat(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return float('nan')


class Status:
    def __init__(self, max_iters: int, bar: bool = True, log_file: str | None = None,
                 log_interval: int = 1, logger_name: str = 'logger') -> None:
        if bar:
            try:
                from tqdm import tqdm
            except ImportError:
                warnings.warn('tqdm is not installed; no progress bar')
            else:
                self.bar = tqdm(total=max_iters)
        self._max_iters = max_iters
        self._batches_done = 0
        self._loss = None
        self._log_file = log_file
        if log_file is not None:
            logging.basicConfig(
                filename=log_file, filemode='w',
                format='%(asctime)s:%(filename)s:%(levelname)s: %(message)s')
            self._logger = logging.getLogger(logger_name)
            self._logger.setLevel(logging.DEBUG)
        self._log_interval = log_interval
        self._step_start = time.time()

    @property
    def max_iters(self):
        return self._max_iters

    @property
    def batches_done(self):
        return self._batches_done

    @batches_done.setter
    def batches_done(self, value):
        self._batches_done = value

    def print(self, *args, **kwargs):
        if hasattr(self, 'bar'):
            self.bar.write(*args, **kwargs)
        else:
            print(*args, **kwargs)

    def log(self, message, level='info'):
        if hasattr(self, '_logger'):
            getattr(self._logger, level)(message)
        else:
            warnings.warn('No Logger. Printing to stdout.')
            self.print(message)

    def log_device(self):
        import torch
        if not torch.cuda.is_available():
            self.log('Devices: cpu')
            return
        used = torch.cuda.memory_allocated() / 2 ** 20
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 20
        self.log(f'Devices:\n{torch.cuda.get_device_name(0)}: {used:.0f}MiB / {total:.0f}MiB')

    # ---- a step ----

    def update(self, **kwargs) -> None:
        if self._loss is None:
            self._init_loss(kwargs.keys())

        should_log = (self._log_file is not None
                      and self.batches_done % self._log_interval == 0)
        show_bar = hasattr(self, 'bar')

        postfix = []
        logged = {}
        for k, v in kwargs.items():
            if should_log or show_bar:
                v = _tofloat(v)  # the host sync happens here, only when displayed
                postfix.append(f'{k} : {v:.5f}')
                logged[k] = round(v, 6)
            # setdefault: a key may first appear mid-run, giving uneven series
            self._loss.setdefault(k, []).append(v)

        if should_log:
            duration = time.time() - self._step_start
            eta_sec = int((self.max_iters - self.batches_done) * duration)
            eta = datetime.timedelta(seconds=eta_sec)
            self.log(f'STEP: {self.batches_done} / {self.max_iters} '
                     f'INFO: {logged} ETA: {eta}')
        if self.batches_done == 0 and self._log_file is not None:
            self.log_device()

        self.batches_done += 1
        self._step_start = time.time()

        if show_bar:
            self.bar.set_postfix_str(' '.join(postfix))
            self.bar.update(1)

    def loss_tail(self, window: int) -> dict:
        '''The last `window` values of each series, as floats (reads just
        those values). Series may have uneven lengths.'''
        if self._loss is None:
            return {}
        return {k: [_tofloat(v) for v in vs[-window:]]
                for k, vs in self._loss.items()}

    def load_state_dict(self, state_dict: dict) -> None:
        '''fast-forward after checkpoint resume'''
        self._loss = state_dict['loss']
        self.batches_done = state_dict['batches_done']
        if self.batches_done > 0 and hasattr(self, 'bar'):
            self.bar.update(self.batches_done)

    def state_dict(self) -> dict:
        loss = None
        if self._loss is not None:
            loss = {k: [_tofloat(v) for v in vs] for k, vs in self._loss.items()}
        return dict(loss=loss, batches_done=self.batches_done)

    def _init_loss(self, keys):
        self._loss = {key: [] for key in keys}

    def plot_loss(self, filename='loss'):
        try:
            import matplotlib
            matplotlib.use('agg')
            import matplotlib.pyplot as plt
        except ImportError:
            warnings.warn('matplotlib is not installed; no loss plot')
            return
        plt.figure(figsize=(12, 8))
        legends = []
        for key, values in self._loss.items():
            legends.append(key)
            plt.plot([_tofloat(v) for v in values])
        plt.xlabel('iteration')
        plt.ylabel('loss')
        plt.legend(legends, loc='upper right')
        plt.tight_layout()
        plt.savefig(filename)
        plt.close()
