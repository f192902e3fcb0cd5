"""Feature extraction driver: wavs + markers -> on-disk training features
(port of ``daft_exprt_tpu/frontend/extract_features.py``).

Per utterance: trim leading/tailing silences, extract log-mel + frame/symbol
energy + frame/symbol log-pitch + integer durations, update markers with
word boundaries / EOS, write `.npy/.markers/.frames_nrg/.symbols_nrg/
.frames_f0/.symbols_f0` (the JAX package's formats, line for line), and pin
the feature config next to the outputs.

Mel and energy run on ``device`` (default cuda) through ``ops/mel.py``;
durations and markers stay on the host; pitch comes from the native
binary or the card's tracker (``pitch_method``). A file whose extraction
raises is logged and skipped, as in the JAX package; the driver returns
the names it extracted, so a caller can hold the count.
"""
import json
import logging
import os
import shutil
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.frontend.audio import load_wav
from daft_exprt_torch.frontend.duration import (
    duration_to_integer, get_min_phone_duration,
)
from daft_exprt_torch.frontend.markers import update_markers
from daft_exprt_torch.frontend.pitch import extract_pitch
from daft_exprt_torch.hparams import FEATURES_HPARAMS
from daft_exprt_torch.ops.mel import MelExtractor

_logger = logging.getLogger(__name__)


def check_features_config_used(features_dir, hparams):
    """Compare the current config with configs saved in the features dir."""
    same = True
    for root, _, file_names in os.walk(os.path.normpath(features_dir)):
        for cfg in (x for x in file_names if x.endswith('.json')):
            with open(os.path.join(root, cfg)) as f:
                prev = types.SimpleNamespace(**json.load(f))
            for param in FEATURES_HPARAMS:
                if getattr(hparams, param) != getattr(prev, param, None):
                    same = False
                    _logger.warning(
                        f'Parameter "{param}" differs in "{root}" -- was '
                        f'{getattr(prev, param, None)}, now '
                        f'{getattr(hparams, param)}')
            break
    return same


def get_symbols_energy(energy, markers):
    """Mean energy per symbol."""
    idx, out = 0, []
    for marker in markers:
        int_dur = int(marker[2])
        if int_dur != 0:
            out.append(f'{np.mean(energy[idx: idx + int_dur]):.3f}\n')
            idx += int_dur
        else:
            out.append(f'{0.:.3f}\n')
    return out


def get_symbols_pitch(pitch, markers):
    """Mean voiced pitch per symbol."""
    idx, out = 0, []
    for marker in markers:
        int_dur = int(marker[2])
        if int_dur != 0:
            seg = pitch[idx: idx + int_dur]
            seg = seg[seg > 0.0]
            out.append(f'{np.mean(seg):.3f}\n' if len(seg) else f'{0.:.3f}\n')
            idx += int_dur
        else:
            out.append(f'{0.:.3f}\n')
    return out


def _process_utterance(markers_file, wav_file, features_dir, hparams,
                       mel_extractor, pitch_method='auto'):
    """Extract and save all features for one utterance; returns the file
    name on success, None on skip. Mel, energy and the card's pitch run on
    ``mel_extractor.device``."""
    with open(markers_file, 'r', encoding='utf-8') as f:
        lines = f.readlines()

    min_phone_dur = get_min_phone_duration(lines)
    fft_length = hparams.filter_length / hparams.sampling_rate
    if min_phone_dur <= fft_length / 2:
        _logger.warning(f'{markers_file}: min phone duration '
                        f'{min_phone_dur:.4f} <= {fft_length / 2:.4f}')
        return None

    sent_begin = float(lines[0].strip().split('\t')[0])
    sent_end = float(lines[-1].strip().split('\t')[1])
    if sent_end - sent_begin < hparams.minimum_wav_duration / 1000:
        _logger.warning(f'{wav_file}: shorter than '
                        f'{hparams.minimum_wav_duration}ms after trimming')
        return None

    wav, fs = load_wav(wav_file, target_sr=hparams.sampling_rate)
    wav = wav[int(sent_begin * fs): int(sent_end * fs)]

    mel_spec, frames_energy = mel_extractor.with_energy(wav)
    nb_frames = mel_spec.shape[1]

    float_durations = [[float(x[0]) - sent_begin, float(x[1]) - sent_begin]
                       for x in (line.strip().split('\t') for line in lines)]
    int_durations = duration_to_integer(float_durations, hparams,
                                        nb_samples=len(wav))
    if len(int_durations) != len(lines):
        _logger.warning(f'{markers_file}: duration count mismatch '
                        f'{len(int_durations)} vs {len(lines)}')
        return None
    diff = nb_frames - sum(int_durations)
    if diff != 0:
        if int_durations[-1] + diff >= 0:
            int_durations[-1] += diff
        else:
            _logger.warning(f'{markers_file}: cannot fix frame mismatch '
                            f'{diff}')
            return None
    if 0 in int_durations:
        _logger.warning(f'{markers_file}: zero duration in {int_durations}')
        return None

    file_name = os.path.basename(markers_file).replace('.markers', '')
    sentence_file = os.path.join(os.path.dirname(markers_file),
                                 f'{file_name}.lab')
    with open(sentence_file, 'r', encoding='utf-8') as f:
        sentence = f.readline()
    markers = update_markers(file_name, lines, sentence, sent_begin,
                             int_durations, hparams)
    if markers is None:
        return None

    np.save(os.path.join(features_dir, f'{file_name}.npy'), mel_spec)
    with open(os.path.join(features_dir, f'{file_name}.markers'), 'w',
              encoding='utf-8') as f:
        f.writelines('\t'.join(x) + '\n' for x in markers)

    with open(os.path.join(features_dir, f'{file_name}.frames_nrg'), 'w',
              encoding='utf-8') as f:
        f.writelines(f'{v:.3f}\n' for v in frames_energy)
    with open(os.path.join(features_dir, f'{file_name}.symbols_nrg'), 'w',
              encoding='utf-8') as f:
        f.writelines(get_symbols_energy(frames_energy, markers))

    frames_pitch = extract_pitch(wav, fs, hparams, method=pitch_method,
                                 device=mel_extractor.device)
    if len(frames_pitch) > nb_frames:
        frames_pitch = frames_pitch[:nb_frames]
    elif len(frames_pitch) < nb_frames:
        last = frames_pitch[-1] if len(frames_pitch) else 0.0
        frames_pitch = np.append(
            frames_pitch, [last] * (nb_frames - len(frames_pitch)))
    with open(os.path.join(features_dir, f'{file_name}.frames_f0'), 'w',
              encoding='utf-8') as f:
        f.writelines(f'{v:.3f}\n' for v in frames_pitch)
    with open(os.path.join(features_dir, f'{file_name}.symbols_f0'), 'w',
              encoding='utf-8') as f:
        f.writelines(get_symbols_pitch(frames_pitch, markers))
    return file_name


def extract_features(dataset_dir, features_dir, hparams, n_jobs=1,
                     pitch_method='auto', device=None):
    """Per-speaker feature extraction on ``device`` (default cuda; raises
    without CUDA unless ``device='cpu'``). Returns {speaker: names
    extracted in this call}."""
    dev = resolve_device(device)
    extracted = {}
    for speaker in hparams.speakers:
        _logger.info(f'Speaker: "{speaker}"')
        wavs_dir = os.path.join(dataset_dir, speaker, 'wavs')
        markers_dir = os.path.join(dataset_dir, speaker, 'align')
        spk_features_dir = os.path.join(features_dir, speaker)
        os.makedirs(spk_features_dir, exist_ok=True)
        metadata = os.path.join(spk_features_dir, 'metadata.csv')
        if not os.path.isfile(metadata):
            src_meta = os.path.join(dataset_dir, speaker, 'metadata.csv')
            if os.path.isfile(src_meta):
                shutil.copyfile(src_meta, metadata)
        with open(metadata, 'r', encoding='utf-8') as f:
            lines = f.readlines()
        file_names = [line.strip().split('|')[0].strip() for line in lines
                      if line.strip()]
        file_names = [
            x for x in file_names
            if os.path.isfile(os.path.join(markers_dir, f'{x}.markers'))]

        done = {x.replace('.symbols_f0', '')
                for x in os.listdir(spk_features_dir)
                if x.endswith('.symbols_f0')}
        todo = [x for x in file_names if x not in done]
        _logger.info(f'{len(done)} files already processed, '
                     f'{len(todo)} to process')

        mel_extractor = MelExtractor(hparams, device=dev)

        def work(name):
            try:
                return _process_utterance(
                    os.path.join(markers_dir, f'{name}.markers'),
                    os.path.join(wavs_dir, f'{name}.wav'),
                    spk_features_dir, hparams, mel_extractor, pitch_method)
            except Exception as e:      # noqa: BLE001 — skip-and-log per file
                _logger.warning(f'{name}: extraction failed: {e}',
                                exc_info=True)
                return None

        if n_jobs > 1:
            # threads: the card's work and the pitch subprocess release the
            # GIL
            with ThreadPoolExecutor(max_workers=n_jobs) as pool:
                results = list(pool.map(work, todo))
        else:
            results = [work(name) for name in todo]
        extracted[speaker] = [r for r in results if r is not None]
        _logger.info(f'{len(extracted[speaker])}/{len(todo)} files extracted')

        hparams.save_hyper_params(
            os.path.join(spk_features_dir, 'config.json'))
    return extracted
