"""TensorBoard logging (PyTorch port of ``daft_exprt_tpu/utils/logger.py``).

The writer is imported when a logger is made, not with the module: where
neither ``tensorboardX`` nor ``torch.utils.tensorboard`` (which needs the
``tensorboard`` package) imports, the logger has no writer and the training
loop logs to Python logging only.
"""
import logging

_logger = logging.getLogger(__name__)


def _summary_writer():
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter


class DaftExprtLogger:
    def __init__(self, log_dir):
        writer = _summary_writer()
        if writer is None:
            _logger.warning('no tensorboard writer available; logging to '
                            'python logger only')
            self.writer = None
        else:
            self.writer = writer(log_dir)

    def log_training(self, loss, individual_loss, grad_norm, learning_rate,
                     duration, iteration):
        if self.writer is None:
            return
        self.writer.add_scalar('training/loss', float(loss), iteration)
        self.writer.add_scalar('training/grad_norm', float(grad_norm),
                               iteration)
        self.writer.add_scalar('training/learning_rate', float(learning_rate),
                               iteration)
        self.writer.add_scalar('training/duration_s', float(duration),
                               iteration)
        for key, value in individual_loss.items():
            self.writer.add_scalar(f'training/{key}', float(value), iteration)

    def log_validation(self, loss, individual_loss, iteration):
        if self.writer is None:
            return
        self.writer.add_scalar('validation/loss', float(loss), iteration)
        for key, value in individual_loss.items():
            self.writer.add_scalar(f'validation/{key}', float(value),
                                   iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()
