"""Pitch extraction front end (port of ``daft_exprt_tpu/frontend/pitch.py``):
a per-sample F0 track (int Hz, -1/0 = unvoiced), unvoiced set to 0 in the
log domain, decimated by hop_length to the mel-frame rate.

Two trackers provide the track:
  * the native C++ tracker (``daft-reaper``, built from the repo's
    native/pitch), run as a subprocess;
  * the NCCF tracker on the card (``ops/pitch.py``).
"""
import logging
import os
import shutil
import subprocess
import tempfile
import uuid

import numpy as np
from scipy.io import wavfile

from daft_exprt_torch.device import resolve_device

_logger = logging.getLogger(__name__)

_NATIVE_BINARY_NAMES = ('daft-reaper', 'reaper')
_REPO_NATIVE_BIN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__)))), 'native', 'pitch', 'build',
    'daft-reaper')

_tracker_cache = {}


def find_native_binary():
    """The repo's built native tracker, else one on PATH, else None."""
    if os.path.isfile(_REPO_NATIVE_BIN) and os.access(_REPO_NATIVE_BIN, os.X_OK):
        return _REPO_NATIVE_BIN
    for name in _NATIVE_BINARY_NAMES:
        path = shutil.which(name)
        if path:
            return path
    return None


def per_sample_f0_native(wav, fs, hparams, binary=None):
    """Run the native tracker binary; returns per-sample int16 F0 (Hz,
    -1 = unvoiced). The wav and the track pass through files in the
    system's temporary directory, removed after."""
    binary = binary or find_native_binary()
    if binary is None:
        raise FileNotFoundError('no native pitch binary (build native/pitch '
                                'or put daft-reaper on PATH)')
    wav_int16 = (np.asarray(wav, dtype=np.float64) * 32768.0).astype('int16')
    rand = str(uuid.uuid4())
    tmp_dir = os.path.join(tempfile.gettempdir(), 'daft_exprt_torch_reaper')
    os.makedirs(tmp_dir, exist_ok=True)
    wav_file = os.path.join(tmp_dir, f'{rand}.wav')
    f0_file = os.path.join(tmp_dir, f'{rand}.f0')
    try:
        wavfile.write(wav_file, fs, wav_int16)
        cmd = [binary, '-i', wav_file, '-a', '-f', f0_file,
               '-e', str(hparams.f0_interval), '-m', str(hparams.min_f0),
               '-x', str(hparams.max_f0), '-u', str(hparams.uv_interval),
               '-w', str(hparams.uv_cost)]
        subprocess.check_call(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT)
        with open(f0_file, 'rb') as f:
            pitch = np.frombuffer(f.read(), dtype='int16')
        return np.copy(pitch)
    finally:
        for p in (wav_file, f0_file):
            if os.path.isfile(p):
                os.remove(p)


def per_sample_f0_device(wav, fs, hparams, device=None):
    """The NCCF tracker on ``device`` (default cuda), same output protocol.
    Trackers are cached per parameters and device."""
    from daft_exprt_torch.ops.pitch import PitchTracker
    dev = resolve_device(device)
    key = (fs, hparams.min_f0, hparams.max_f0, hparams.f0_interval,
           hparams.uv_cost, str(dev))
    if key not in _tracker_cache:
        _tracker_cache[key] = PitchTracker(hparams, sr=fs, device=dev)
    return _tracker_cache[key].per_sample_f0(np.asarray(wav, dtype=np.float32))


def extract_pitch(wav, fs, hparams, method='auto', device=None):
    """wav (float32 [-1,1]) -> per-mel-frame log-F0 (0 = unvoiced).

    method: 'native' (C++ binary), 'device' (the card's tracker, on
    ``device``), or 'auto' (native if built, else device).
    """
    if method == 'auto':
        method = 'native' if find_native_binary() is not None else 'device'
    if method == 'native':
        pitch = per_sample_f0_native(wav, fs, hparams)
    elif method == 'device':
        pitch = per_sample_f0_device(wav, fs, hparams, device=device)
    else:
        raise ValueError(method)

    pitch = pitch.astype(np.float64)
    uv_idxs = np.where(pitch <= 0.0)[0]
    pitch[uv_idxs] = 1000.0          # placeholder so log() is defined
    pitch = np.log(pitch)
    pitch[uv_idxs] = 0.0
    pitch_frames = pitch[::hparams.hop_length]
    if len(pitch) % hparams.hop_length == 0:
        pitch_frames = np.append(pitch_frames, pitch[-1])
    return pitch_frames
