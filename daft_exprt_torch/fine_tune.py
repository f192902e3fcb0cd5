"""Vocoder fine-tuning dataset: (predicted-mel, ground-truth-wav) pairs
(PyTorch port of ``daft_exprt_tpu/fine_tune.py``).

The trained acoustic model runs in eval mode over the training set (the
bucketed batches of ``prepare_data_iterators``), each batch normalised with
the dynamic speaker stats exactly as in training. Each prediction is cropped
to its true length, the ground-truth mel is re-extracted from the
marker-cropped wav for a shape check, and ``<file>.npy`` + ``<file>.wav``
pairs are stored per speaker under ``fine_tuning_dataset/``. On the card,
the model's FFT blocks take the fused attention kernel
(``hp.fused_attention = 'auto'``).
"""
import logging
import os
import time

import numpy as np
import torch

from daft_exprt_torch import checkpoint as ckpt
from daft_exprt_torch.data import (
    DynamicSpeakerStatsManager, prepare_data_iterators,
)
from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.frontend.audio import load_wav, save_wav
from daft_exprt_torch.models.daft_exprt import DaftExprt
from daft_exprt_torch.ops.mel import MelExtractor
from daft_exprt_torch.parallel.train_step import MODEL_INPUT_KEYS, to_device
from daft_exprt_torch.utils import estimate_required_time

_logger = logging.getLogger(__name__)


def _load_params(hparams):
    if not hparams.checkpoint:
        raise ValueError('no checkpoint specified in hparams.checkpoint')
    return ckpt.load_acoustic_checkpoint(hparams.checkpoint)[0]


def fine_tuning(hparams, data_set_dir, params=None, device=None):
    """Generate the fine-tuning dataset on ``device`` (default cuda; raises
    without CUDA unless ``device='cpu'``); returns its root directory.
    ``params``: the port's ``DaftExprt`` state dict; without it,
    ``hparams.checkpoint`` (a port checkpoint, or a reference ``.pt``).
    The counts of pairs written and skipped are in ``fine_tuning.counts``
    after a call."""
    dev = resolve_device(device)
    model = DaftExprt.from_hparams(hparams, device=dev)
    if params is None:
        params = _load_params(hparams)
    model.load_state_dict(params, strict=True)
    model.eval()

    train_it, _, _ = prepare_data_iterators(hparams, bucket=True)
    stats_manager = DynamicSpeakerStatsManager(hparams)

    experiment_root = os.path.dirname(os.path.abspath(hparams.training_files))
    ft_data_set = os.path.join(experiment_root, 'fine_tuning_dataset')
    for speaker in hparams.speakers:
        os.makedirs(os.path.join(ft_data_set, speaker), exist_ok=True)

    mel_extractor = MelExtractor(hparams, device=dev)
    n_written = n_skipped_shape = n_skipped_short = 0
    start = time.time()
    for idx, (batch, feature_dirs, feature_files) in enumerate(train_it):
        estimate_required_time(len(train_it), idx, time.time() - start,
                               interval=1)
        norm = stats_manager.process_batch(batch)
        with torch.no_grad():
            out = model(**to_device({k: norm[k] for k in MODEL_INPUT_KEYS},
                                    dev))
        mel_preds = out['mel_preds'].float().cpu().numpy()
        output_lengths = norm['output_lengths']

        for i in range(mel_preds.shape[0]):
            mel_pred = mel_preds[i][:, :int(output_lengths[i])]
            feature_dir, feature_file = feature_dirs[i], feature_files[i]
            speaker_name = next((s for s in hparams.speakers
                                 if feature_dir.rstrip('/').endswith(s)), None)
            if speaker_name is None:
                _logger.warning(f'{feature_dir}: unknown speaker, skipping')
                continue
            wav_file = os.path.join(data_set_dir, speaker_name, 'wavs',
                                    f'{feature_file}.wav')
            wav, fs = load_wav(wav_file, target_sr=hparams.sampling_rate)
            with open(os.path.join(feature_dir,
                                   f'{feature_file}.markers'), 'r',
                      encoding='utf-8') as f:
                lines = f.readlines()
            sent_begin = float(lines[0].strip().split('\t')[0])
            sent_end = float(lines[-1].strip().split('\t')[1])
            wav = wav[int(sent_begin * fs): int(sent_end * fs)]

            mel_tgt = mel_extractor(wav)
            if mel_tgt.shape != mel_pred.shape:
                n_skipped_shape += 1
                _logger.warning(f'{feature_file}: shape mismatch tgt '
                                f'{mel_tgt.shape} vs pred {mel_pred.shape}')
                continue
            if len(wav) < fs:
                n_skipped_short += 1
                continue
            np.save(os.path.join(ft_data_set, speaker_name,
                                 f'{feature_file}.npy'), mel_pred)
            save_wav(os.path.join(ft_data_set, speaker_name,
                                  f'{feature_file}.wav'), wav, fs)
            n_written += 1

    fine_tuning.counts = {'written': n_written,
                          'shape_mismatch': n_skipped_shape,
                          'too_short': n_skipped_short}
    _logger.info(f'Fine-tuning dataset: written={n_written}, shape '
                 f'mismatches={n_skipped_shape}, too short={n_skipped_short}')
    return ft_data_set


def launch_fine_tuning(hparams, data_set_dir, params=None, device=None):
    """Entry point mirroring the reference launcher."""
    return fine_tuning(hparams, data_set_dir, params=params, device=device)
