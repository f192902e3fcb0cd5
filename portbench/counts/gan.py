"""Operations of one HiFi-GAN fine-tuning iteration (a discriminator
step, then a generator step) from its shapes: the generator, the
multi-period and multi-scale discriminators and the loss mel, each
product counted as 2 x its multiply-adds.

Per iteration, in forward passes over the batch: the generator 4 (a
forward in each step, a backward of two in the generator step), the
discriminators 9 (real and generated forwards in each step, a backward
of both in the discriminator step at two forwards each, the input
gradient of the generated pass in the generator step at one), the loss
mel 3 (the target's, and the generated one's forward and backward)."""
import importlib.util
from pathlib import Path

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
MSD_LAYERS = [(1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20),
              (128, 256, 41, 2, 16, 20), (256, 512, 41, 4, 16, 20),
              (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
              (1024, 1024, 5, 1, 1, 2), (1024, 1, 3, 1, 1, 1)]
N_FFT, HOP, N_MELS = 1024, 256, 80


def _generator():
    spec = importlib.util.spec_from_file_location(
        'portbench_counts_generator_g', Path(__file__).with_name('generator.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mpd_macs(n):
    """Multiply-adds of the multi-period discriminator on one waveform of
    ``n`` samples."""
    total = 0
    for p in MPD_PERIODS:
        h = -(-n // p)
        for i, (cin, cout) in enumerate(MPD_CHANNELS):
            stride = 3 if i < 4 else 1
            h = (h + 4 - 5) // stride + 1
            total += h * p * cout * cin * 5
        total += h * p * 1024 * 3
    return total


def msd_macs(n):
    """Multiply-adds of the multi-scale discriminator on one waveform of
    ``n`` samples (the scales see it average-pooled 4/2, padding 2)."""
    total = 0
    for s in range(3):
        if s:
            n = (n + 4 - 4) // 2 + 1
        length = n
        for cin, cout, k, stride, groups, pad in MSD_LAYERS:
            length = (length + 2 * pad - k) // stride + 1
            total += length * cout * (cin // groups) * k
    return total


def mel_macs(n):
    frames = (n + (N_FFT - HOP) - N_FFT) // HOP + 1
    bins = N_FFT // 2 + 1
    return frames * (2 * N_FFT * bins + bins * N_MELS)


def iteration_ops(batch, segment, voc_cfg):
    g = _generator().conv_macs(segment // HOP, voc_cfg)
    g_macs = g['mrf'] + g['edge']
    d_macs = mpd_macs(segment) + msd_macs(segment)
    return 2 * batch * (4 * g_macs + 9 * d_macs + 3 * mel_macs(segment))
