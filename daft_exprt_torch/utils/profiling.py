"""Tracing and timing helpers (PyTorch port of
``daft_exprt_tpu/utils/profiling.py``): a ``torch.profiler`` trace written
as a Chrome trace, a synchronise over the CUDA tensors of a result,
wall-clocked sections and an audio-seconds per second counter, with the
JAX module's arithmetic."""
import contextlib
import logging
import os
import time

import torch

_logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profiler_trace(log_dir, name='trace.json'):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where CUDA is available) and write its Chrome trace to
    ``log_dir/name`` (viewable in Perfetto or chrome://tracing). Yields the
    profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    _logger.info(f'profiler trace written to {path}')


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def synchronize(tree):
    """Wait for the device work that produces the tensors of ``tree``
    (nested dicts, lists and tuples): ``torch.cuda.synchronize`` on the
    device of each CUDA leaf; host leaves need none."""
    for dev in {t.device for t in _leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed_section(name, results=None):
    """Wall-clock a section; the caller synchronises inside if it launches
    asynchronous device work."""
    start = time.perf_counter()
    yield
    elapsed = time.perf_counter() - start
    _logger.info(f'[{name}] {elapsed * 1000:.1f} ms')
    if results is not None:
        results[name] = elapsed


class ThroughputCounter:
    """Audio-seconds/s accounting across synthesis batches."""

    def __init__(self, hparams):
        self.hop = hparams.hop_length
        self.n_fft = hparams.filter_length
        self.sr = hparams.sampling_rate
        self.centered = hparams.centered
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0

    def frames_to_seconds(self, n_frames):
        nb_samples = (n_frames - 1) * self.hop + self.n_fft
        if self.centered:
            nb_samples -= 2 * (self.n_fft // 2)
        return nb_samples / self.sr

    def add(self, n_frames_list, wall_seconds):
        self.audio_seconds += sum(self.frames_to_seconds(int(n))
                                  for n in n_frames_list)
        self.wall_seconds += wall_seconds

    @property
    def rate(self):
        return self.audio_seconds / max(self.wall_seconds, 1e-9)

    def report(self):
        _logger.info(f'{self.audio_seconds:.1f} audio-s in '
                     f'{self.wall_seconds:.1f}s -> {self.rate:.1f} '
                     f'audio-s/s (RTF {self.rate:.2f})')
        return self.rate
