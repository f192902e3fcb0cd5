"""ECAPA-TDNN speaker embedding precompute (model-zoo external; the port's
copy of ``daft_exprt_tpu/frontend/ecapa.py``, reading wavs with
``daft_exprt_torch.frontend.audio.load_wav``).

Capability parity with the reference
(reference: src/daft_exprt/ecapa_embeddings.py:19-61): for every
``features_dir|file|speaker_id`` entry, load the source wav, resample to
16 kHz, encode with SpeechBrain's spkrec-ecapa-voxceleb, and save the 192-d
embedding as ``<file>.spk_emb.npy`` next to the features.

SpeechBrain is an optional runtime dependency (not in this image — SURVEY.md
§2.4 classes it as a model-zoo external); the loader is gated with a clear
error, and ``embed_fn`` injection lets tests or alternative encoders plug in.
The SpeechBrain encoder runs on ``device`` (default cuda; raises without it
unless given 'cpu'); with ``embed_fn`` no device is used.
"""
import logging
import os

import numpy as np

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.frontend.audio import load_wav

_logger = logging.getLogger(__name__)

_ECAPA_SR = 16000


def _load_speechbrain_encoder(device=None):
    device = str(resolve_device(device))
    try:
        from speechbrain.pretrained import EncoderClassifier
    except ImportError:
        try:
            from speechbrain.inference import EncoderClassifier
        except ImportError as exc:
            raise ImportError(
                'speechbrain is required for ECAPA embedding extraction '
                '(pip install speechbrain), or pass embed_fn= / precompute '
                '.spk_emb.npy files externally') from exc
    classifier = EncoderClassifier.from_hparams(
        source='speechbrain/spkrec-ecapa-voxceleb', run_opts={'device': device})

    def embed(wav_16k):
        import torch
        with torch.no_grad():
            emb = classifier.encode_batch(
                torch.FloatTensor(wav_16k)[None, :])
        return emb.squeeze().cpu().numpy()

    return embed


def compute_ecapa_for_file_lists(file_lists, dataset_dir=None, embed_fn=None,
                                 device=None, overwrite=False):
    """file_lists: paths to `features_dir|file|speaker_id` list files.

    Source wavs are looked up as <features_dir>/../../<speaker>/wavs/ or via
    ``dataset_dir``/<speaker>/wavs/<file>.wav.
    """
    if embed_fn is None:
        embed_fn = _load_speechbrain_encoder(device)
    n_done, n_skip = 0, 0
    for list_file in file_lists:
        with open(list_file, 'r', encoding='utf-8') as f:
            entries = [line.strip().split('|') for line in f if line.strip()]
        for features_dir, file_name, _speaker_id in (e[:3] for e in entries):
            out_path = os.path.join(features_dir, f'{file_name}.spk_emb.npy')
            if os.path.isfile(out_path) and not overwrite:
                n_skip += 1
                continue
            speaker = os.path.basename(os.path.normpath(features_dir))
            candidates = []
            if dataset_dir is not None:
                candidates.append(os.path.join(dataset_dir, speaker, 'wavs',
                                               f'{file_name}.wav'))
            candidates.append(os.path.join(
                os.path.dirname(os.path.normpath(features_dir)), speaker,
                'wavs', f'{file_name}.wav'))
            wav_path = next((c for c in candidates if os.path.isfile(c)),
                            None)
            if wav_path is None:
                _logger.warning(f'no source wav for {file_name} '
                                f'(tried {candidates})')
                continue
            wav, _ = load_wav(wav_path, target_sr=_ECAPA_SR)
            emb = np.asarray(embed_fn(wav), dtype=np.float32).reshape(-1)
            np.save(out_path, emb)
            n_done += 1
    _logger.info(f'ECAPA embeddings: {n_done} computed, {n_skip} existing')
    return n_done


def average_embedding_from_wav_dir(wav_dir, embed_fn=None, device=None):
    """Average ECAPA embedding over all wavs in a directory (used by
    synthesis --speaker_audios, reference: scripts/synthesize.py:219-260)."""
    if embed_fn is None:
        embed_fn = _load_speechbrain_encoder(device)
    embs = []
    for wav_file in sorted(os.listdir(wav_dir)):
        if not wav_file.endswith('.wav'):
            continue
        wav, _ = load_wav(os.path.join(wav_dir, wav_file),
                          target_sr=_ECAPA_SR)
        embs.append(np.asarray(embed_fn(wav), dtype=np.float32).reshape(-1))
    if not embs:
        raise ValueError(f'no wav files in {wav_dir}')
    return np.mean(np.stack(embs), axis=0)
