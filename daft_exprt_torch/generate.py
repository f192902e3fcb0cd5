"""Synthesis entry point (PyTorch port of ``daft_exprt_tpu/generate.py``):
sentences phonemized with the MFA dictionary (``phonemize_sentence``,
``prepare_sentences_for_inference``; host code, copied), external symbol
prosody -> host prosody transforms -> ``Synthesizer``
(acoustic model on bucket-padded batches) -> vocoder -> outputs, with the
RTF accounting of ``generate_mel_specs``; and
``extract_reference_parameters``, a reference recording's energy, pitch and
mel for accent conditioning, extracted on the card.

The prosody transforms run on the host in numpy, exactly as the JAX
package runs them; the models run on the device the caller built them on.
"""
import collections
import functools
import logging
import os
import random
import re
import subprocess
import time
import uuid
from shutil import rmtree

import numpy as np
import torch

from daft_exprt_torch.device import resolve_device
from daft_exprt_torch.frontend.audio import load_wav, save_wav
from daft_exprt_torch.frontend.duration import duration_to_integer
from daft_exprt_torch.frontend.pitch import extract_pitch
from daft_exprt_torch.ops.mel import MelExtractor
from daft_exprt_torch.text.cleaners import collapse_whitespace, text_cleaner
from daft_exprt_torch.text.symbols import (
    ascii_letters, eos, punctuation, whitespace,
)
from daft_exprt_torch.utils import (
    chunker, have_matplotlib, launch_multi_process, plot_2d_data,
)

_logger = logging.getLogger(__name__)
FILE_ROOT = os.path.dirname(os.path.realpath(__file__))


# ----------------------------------------------------------------------
# text -> phonemes (copies of generate.py:42-143)
# ----------------------------------------------------------------------

def phonemize_sentence(sentence, hparams, log_queue=None):
    """Phonemize with the MFA dictionary ``hparams.mfa_dictionary`` (a word
    with several pronunciations takes one at random); out-of-vocabulary
    words go through the external ``mfa g2p`` command with
    ``hparams.mfa_g2p_model``. Nothing is downloaded."""
    word_trans = collections.defaultdict(list)
    with open(hparams.mfa_dictionary, 'r', encoding='utf-8') as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                word_trans[parts[0].lower()].append(parts[1:])

    if hparams.language == 'english':
        all_chars = ascii_letters + punctuation
    else:
        raise NotImplementedError(hparams.language)

    sentence = text_cleaner(sentence.strip(), hparams.language).lower().strip()
    sent_words = re.findall(rf"[\w']+|[{punctuation}]", sentence)
    sent_words = [x for x in sent_words
                  if len(re.sub(f'[^{all_chars}]', '', x)) != 0]
    while sent_words and sent_words[0] in punctuation:
        sent_words.pop(0)
    punctuation_end = None
    while sent_words and sent_words[-1] in punctuation:
        punctuation_end = sent_words.pop(-1)
    sent_words.append(punctuation_end)

    phonemized, unk_words = [], []
    while len(sent_words) != 0:
        word = sent_words.pop(0)
        if word is None:
            phonemized.append(None)
        elif word in word_trans:
            phonemized.append(random.choice(word_trans[word]))
        else:
            unk_words.append(word)
            phonemized.append('<unk>')
        if len(sent_words) != 0:
            bound = sent_words.pop(0) if sent_words[0] in punctuation \
                else whitespace
            phonemized.append(bound)
    # the trailing None placeholder (end punctuation) folds away
    phonemized = [x for x in phonemized if x is not None]
    if punctuation_end is not None and phonemized[-1] != punctuation_end:
        phonemized.append(punctuation_end)
    phonemized.append(eos)

    if unk_words:
        rand = str(uuid.uuid4())
        oovs = os.path.join(FILE_ROOT, f'{rand}_oovs.txt')
        with open(oovs, 'w', encoding='utf-8') as f:
            f.write('\n'.join(unk_words) + '\n')
        oovs_trans = os.path.join(FILE_ROOT, f'{rand}_oovs_trans.txt')
        tmp_dir = os.path.join(FILE_ROOT, rand)
        try:
            subprocess.run(['mfa', 'g2p', hparams.mfa_g2p_model, oovs,
                            oovs_trans, '-t', tmp_dir], check=False)
            if os.path.isfile(oovs_trans):
                with open(oovs_trans, 'r', encoding='utf-8') as f:
                    for line in f:
                        parts = line.strip().split()
                        if '<unk>' in phonemized:
                            phonemized[phonemized.index('<unk>')] = parts[1:]
        finally:
            for p in (oovs, oovs_trans):
                if os.path.isfile(p):
                    os.remove(p)
            rmtree(tmp_dir, ignore_errors=True)
    return phonemized


def prepare_sentences_for_inference(text_file, output_dir, hparams, n_jobs=1):
    """Phonemize a sentences file (one sentence a line) into
    ``output_dir/sentences_to_generate.txt``; returns (sentences,
    file_names). ``hparams.update_mfa_paths()`` runs first, as in the JAX
    package: the dictionary is the one under the user's home
    (``~/Documents/MFA/pretrained_models``). The workers (``n_jobs`` > 1)
    are forked processes that run host Python only."""
    if os.path.exists(output_dir):
        rmtree(output_dir)
    os.makedirs(output_dir, exist_ok=False)
    with open(text_file, 'r', encoding='utf-8') as f:
        raw = [line.strip() for line in f if line.strip()]
    file_names = [f'{os.path.basename(text_file)}_line{idx}'
                  for idx in range(len(raw))]
    hparams.update_mfa_paths()
    sentences = launch_multi_process(iterable=raw, func=phonemize_sentence,
                                     n_jobs=n_jobs, timer_verbose=False,
                                     hparams=hparams)
    with open(os.path.join(output_dir, 'sentences_to_generate.txt'), 'w',
              encoding='utf-8') as f:
        for sentence, file_name in zip(sentences, file_names):
            text = ''
            for item in sentence:
                if isinstance(item, list):
                    item = '{' + ' '.join(item) + '}'
                text = f'{text} {item} '
            f.write(f'{file_name}|{collapse_whitespace(text).strip()}\n')
    return sentences, file_names


# ----------------------------------------------------------------------
# host-side prosody transforms (copies of generate.py:146-216)
# ----------------------------------------------------------------------

def get_int_durations(duration_preds, hparams):
    """Float-second durations -> integer frame durations, per batch row."""
    duration_preds = np.array(duration_preds, dtype=np.float64)
    fft_length = hparams.filter_length / hparams.sampling_rate
    dur_min = fft_length / 2
    duration_preds[duration_preds < dur_min] = 0.0
    durations_int = np.zeros(duration_preds.shape, dtype=np.int64)
    for row in range(duration_preds.shape[0]):
        end_prev, idxs, segs = 0.0, [], []
        for col in range(duration_preds.shape[1]):
            d = float(duration_preds[row, col])
            if d != 0.0:
                idxs.append(col)
                segs.append([end_prev, end_prev + d])
                end_prev += d
        if segs:
            ints = duration_to_integer(segs, hparams)
            durations_int[row, idxs] = ints[:len(idxs)]
    return duration_preds.astype(np.float32), durations_int


def pitch_shift(pitch_preds, pitch_factors, hparams, speaker_ids):
    """Hz-domain pitch shift on normalized log-pitch."""
    pitch_preds = np.array(pitch_preds, dtype=np.float64)
    voiced = pitch_preds != 0.0
    for row in range(pitch_preds.shape[0]):
        sid = int(speaker_ids[row])
        mean = hparams.stats[f'spk {sid}']['pitch']['mean']
        std = hparams.stats[f'spk {sid}']['pitch']['std']
        hz = np.exp(std * pitch_preds[row] + mean) + pitch_factors[row]
        pitch_preds[row] = (np.log(np.maximum(hz, 1e-8)) - mean) / std
    pitch_preds[~voiced] = 0.0
    return pitch_preds.astype(np.float32)


def pitch_multiply(pitch_preds, pitch_factors):
    """Amplify/flatten/invert pitch deviation around the voiced mean."""
    pitch_preds = np.array(pitch_preds, dtype=np.float64)
    factors = np.asarray(pitch_factors, dtype=np.float64)
    for row in range(pitch_preds.shape[0]):
        voiced = pitch_preds[row] != 0.0
        if not voiced.any():
            continue
        mean = pitch_preds[row][voiced].mean()
        deviation = (pitch_preds[row] - mean) * factors[row]
        pitch_preds[row] = pitch_preds[row] + deviation
        pitch_preds[row][~voiced] = 0.0
    return pitch_preds.astype(np.float32)


def normalize_external_feature(values, zero_mask, target_stats,
                               source_stats=None):
    """Source -> target z-score remap preserving zeros."""
    values = np.array(values, dtype=np.float64)
    non_zero = ~zero_mask
    if source_stats is not None:
        if source_stats['std'] == 0:
            raise ValueError('Source stats std cannot be 0.')
        tmp = (values[non_zero] - source_stats['mean']) / source_stats['std']
        values[non_zero] = tmp * target_stats['std'] + target_stats['mean']
    if target_stats['std'] == 0:
        raise ValueError('Target speaker stats std cannot be 0.')
    values[non_zero] = (values[non_zero] - target_stats['mean']) \
        / target_stats['std']
    values[zero_mask] = 0.0
    return values.astype(np.float32)


def collate_for_synthesis(batch_sentences, batch_dur_factors,
                          batch_energy_factors, batch_pitch_factors,
                          pitch_transform, batch_speaker_ids,
                          batch_file_names, hparams, external_prosody=None):
    """Symbols + factors -> padded numpy arrays, sorted by length desc."""
    seqs = []
    for sent, dur_f, nrg_f, f0_f in zip(batch_sentences, batch_dur_factors,
                                        batch_energy_factors,
                                        batch_pitch_factors):
        symbols = []
        for item in sent:
            if isinstance(item, list):
                symbols += [hparams.symbols.index(p) for p in item]
            else:
                symbols.append(hparams.symbols.index(item))
        n = len(symbols)
        dur_f = [1.0] * n if dur_f is None else list(dur_f)
        nrg_f = [1.0] * n if nrg_f is None else list(nrg_f)
        if f0_f is None:
            f0_f = [0.0] * n if pitch_transform == 'add' else [1.0] * n
        if not len(dur_f) == len(nrg_f) == len(f0_f) == n:
            raise ValueError(f'factor lengths {len(dur_f)}, {len(nrg_f)}, '
                             f'{len(f0_f)} differ from the {n} symbols')
        seqs.append((symbols, dur_f, nrg_f, f0_f))

    order = np.argsort([-len(s[0]) for s in seqs], kind='stable')
    max_len = len(seqs[order[0]][0])
    B = len(seqs)
    symbols = np.zeros((B, max_len), dtype=np.int64)
    dur_factors = np.ones((B, max_len), dtype=np.float32)
    energy_factors = np.ones((B, max_len), dtype=np.float32)
    pitch_factors = (np.zeros if pitch_transform == 'add'
                     else np.ones)((B, max_len)).astype(np.float32)
    input_lengths = np.zeros((B,), dtype=np.int64)
    speaker_ids = np.zeros((B,), dtype=np.int64)
    file_names, sorted_external = [], None
    for i, src in enumerate(order):
        s, df, ef, pf = seqs[src]
        n = len(s)
        symbols[i, :n] = s
        dur_factors[i, :n] = df
        energy_factors[i, :n] = ef
        pitch_factors[i, :n] = pf
        input_lengths[i] = n
        speaker_ids[i] = batch_speaker_ids[src]
        file_names.append(batch_file_names[src])
    if external_prosody is not None:
        sorted_external = [external_prosody[src] for src in order]
    return (symbols, dur_factors, energy_factors, pitch_factors,
            input_lengths, speaker_ids, file_names, sorted_external)


def _round_to_bucket(value, buckets):
    for b in buckets:
        if value <= b:
            return b
    # beyond the largest bucket: round up to a multiple of the last stride
    stride = buckets[-1] - buckets[-2] if len(buckets) > 1 else buckets[-1]
    return buckets[-1] + -(-(value - buckets[-1]) // stride) * stride


# ----------------------------------------------------------------------
# synthesis entry point
# ----------------------------------------------------------------------

class Synthesizer:
    """Runs ``DaftExprt.inference`` on bucket-padded numpy batches on the
    model's device; ``vocoder`` (a ``HiFiGanVocoder``) turns the mels into
    waveforms in :func:`generate_batch_mel_specs`."""

    def __init__(self, model, hparams, vocoder=None):
        self.model = model
        self.hparams = hparams
        self.vocoder = vocoder
        self.device = next(model.parameters()).device

    def infer(self, symbols, duration_preds, durations_int, energy_preds,
              pitch_preds, input_lengths, spk_embs, accent_emb,
              bucket=True):
        """Pads to buckets, runs the model, returns numpy (mel, alignments,
        output_lengths) cropped to the true T_max."""
        hp = self.hparams
        B, L = symbols.shape
        output_lengths = durations_int.sum(axis=1).astype(np.int64)
        output_lengths[output_lengths == 0] = 1
        T_true = int(output_lengths.max())
        if bucket:
            L_pad = _round_to_bucket(L, hp.length_buckets)
            T_pad = _round_to_bucket(T_true, hp.frame_buckets)
        else:
            L_pad, T_pad = L, T_true

        def dev(x, n=None, dtype=None):
            x = np.asarray(x)
            if n is not None:
                x = np.pad(x, ((0, 0), (0, n - x.shape[1])))
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        out = self.model.inference(
            symbols=dev(symbols, L_pad, torch.long),
            duration_preds=dev(duration_preds, L_pad, torch.float32),
            durations_int=dev(durations_int, L_pad, torch.long),
            energy_preds=dev(energy_preds, L_pad, torch.float32),
            pitch_preds=dev(pitch_preds, L_pad, torch.float32),
            input_lengths=dev(input_lengths, dtype=torch.long),
            output_lengths=dev(output_lengths, dtype=torch.long),
            n_frames=T_pad,
            spk_embs=dev(spk_embs, dtype=torch.float32),
            accent_emb=dev(accent_emb, dtype=torch.float32))
        mel = out['mel_preds'][:, :, :T_true].float().cpu().numpy()
        weights = out['alignments'][:, :L, :T_true].float().cpu().numpy()
        return mel, weights, output_lengths


def _external_prosody(sorted_external, input_lengths, speaker_ids,
                      file_names, hparams, source_stats, alpha_dur,
                      alpha_pitch, alpha_energy):
    """Per-symbol durations (s), energy and pitch from the external
    prosody entries, normalised to the target speakers' stats."""
    B, max_len = len(sorted_external), int(input_lengths.max())
    ext_duration = np.zeros((B, max_len), dtype=np.float32)
    ext_energy = np.zeros((B, max_len), dtype=np.float32)
    ext_pitch = np.zeros((B, max_len), dtype=np.float32)
    hop_in_seconds = hparams.hop_length / hparams.sampling_rate
    for idx, (entry, seq_len) in enumerate(zip(sorted_external,
                                               input_lengths.tolist())):
        if len(entry['symbols']) != seq_len:
            raise ValueError(
                f'External prosody length mismatch for {file_names[idx]}: '
                f"{len(entry['symbols'])} vs {seq_len}")
        # a copy: the caller's arrays stay as they were
        frames = np.array(entry['durations_frames'], dtype=np.float64)
        dur_mask = frames > 0
        if dur_mask.any() and alpha_dur != 1.0:
            mean = frames[dur_mask].mean()
            frames[dur_mask] = mean + alpha_dur * (frames[dur_mask] - mean)
            frames = np.clip(frames, 0.0, None)
        ext_duration[idx, :seq_len] = frames * hop_in_seconds

        energy_vals = np.array(entry['energy'], dtype=np.float64)
        pitch_vals = np.array(entry['pitch'], dtype=np.float64)
        energy_zero = energy_vals == 0.0
        pitch_zero = pitch_vals == 0.0
        sid = int(speaker_ids[idx])
        spk_key = f'spk {sid}'
        if spk_key not in hparams.stats and 'spk 0' in hparams.stats:
            spk_key = 'spk 0'
        if spk_key not in hparams.stats:
            raise KeyError(f"Speaker stats missing for 'spk {sid}' "
                           f'(keys: {list(hparams.stats.keys())})')
        st = hparams.stats[spk_key]
        energy_vals = normalize_external_feature(
            energy_vals, energy_zero,
            {'mean': st['energy']['mean'], 'std': st['energy']['std']},
            source_stats['energy'] if source_stats else None)
        pitch_vals = normalize_external_feature(
            pitch_vals, pitch_zero,
            {'mean': st['pitch']['mean'], 'std': st['pitch']['std']},
            source_stats['pitch'] if source_stats else None)
        if alpha_energy != 1.0:
            energy_vals[~energy_zero] *= alpha_energy
        if alpha_pitch != 1.0:
            pitch_vals[~pitch_zero] *= alpha_pitch
        ext_energy[idx, :seq_len] = energy_vals
        ext_pitch[idx, :seq_len] = pitch_vals
    return ext_duration, ext_energy, ext_pitch


def _per_row(emb, B, name):
    if emb is None:
        raise ValueError(f'{name} required for inference')
    emb = np.asarray(emb, dtype=np.float32)
    return np.tile(emb[None], (B, 1)) if emb.ndim == 1 else emb


def generate_batch_mel_specs(synthesizer, batch_sentences, batch_dur_factors,
                             batch_energy_factors, batch_pitch_factors,
                             pitch_transform, batch_speaker_ids,
                             batch_file_names, output_dir, hparams,
                             batch_external_prosody=None, source_stats=None,
                             alpha_dur=1.0, alpha_pitch=1.0, alpha_energy=1.0,
                             external_embeddings=None,
                             external_accent_emb=None, save_outputs=True):
    """One batch: prosody assembly -> inference -> vocode -> outputs. With
    ``save_outputs`` each utterance's mel (``.npz``), mel/alignment figure
    (``.png``, where matplotlib is installed) and waveform (``.wav``,
    through ``synthesizer.vocoder``, one utterance a call as the JAX
    package vocodes) are written to ``output_dir``."""
    batch_file_names = [f'{name}_spk_{sid}' for name, sid
                        in zip(batch_file_names, batch_speaker_ids)]
    (symbols, dur_factors, energy_factors, pitch_factors, input_lengths,
     speaker_ids, file_names, sorted_external) = collate_for_synthesis(
        batch_sentences, batch_dur_factors, batch_energy_factors,
        batch_pitch_factors, pitch_transform, batch_speaker_ids,
        batch_file_names, hparams, external_prosody=batch_external_prosody)
    if sorted_external is None:
        raise ValueError('external symbol prosody is required: the prosody '
                         'predictor is external in this model family')
    B = symbols.shape[0]
    ext_duration, ext_energy, ext_pitch = _external_prosody(
        sorted_external, input_lengths, speaker_ids, file_names, hparams,
        source_stats, alpha_dur, alpha_pitch, alpha_energy)

    # factors + duration re-quantization + pitch transform (host)
    duration_preds = ext_duration * dur_factors
    duration_preds, durations_int = get_int_durations(duration_preds, hparams)
    energy_preds = ext_energy * energy_factors
    energy_preds[durations_int == 0] = 0.0
    pitch_preds = ext_pitch.copy()
    pitch_preds[durations_int == 0] = 0.0
    if pitch_transform == 'add':
        pitch_preds = pitch_shift(pitch_preds, pitch_factors, hparams,
                                  speaker_ids)
    elif pitch_transform == 'multiply':
        pitch_preds = pitch_multiply(pitch_preds, pitch_factors)
    else:
        raise NotImplementedError(pitch_transform)

    mel_preds, weights, output_lengths = synthesizer.infer(
        symbols, duration_preds, durations_int, energy_preds, pitch_preds,
        input_lengths, _per_row(external_embeddings, B,
                                'external_embeddings (ECAPA)'),
        _per_row(external_accent_emb, B, 'external_accent_emb'))

    predictions = {}
    for i in range(B):
        L_i = int(input_lengths[i])
        T_i = int(output_lengths[i])
        mel = mel_preds[i, :, :T_i]
        predictions[file_names[i]] = [
            duration_preds[i, :L_i], durations_int[i, :L_i],
            energy_preds[i, :L_i], pitch_preds[i, :L_i], mel,
            weights[i, :L_i, :T_i]]
        if save_outputs:
            np.savez(os.path.join(output_dir, f'{file_names[i]}.npz'),
                     mel_spec=mel)

    if save_outputs:
        if synthesizer.vocoder is None:
            raise ValueError('HiFi-GAN vocoder required for mel-to-wave '
                             '(pass vocoder= to the Synthesizer)')
        plots = have_matplotlib()
        if not plots:
            _logger.warning('matplotlib is not installed: no .png figures')
        for file_name, (_, _, _, _, mel, weight) in predictions.items():
            if plots:
                plot_2d_data(
                    data=(mel, weight),
                    x_labels=('Mel-Spec Prediction', 'Alignments'),
                    filename=os.path.join(output_dir, file_name + '.png'))
            audio = synthesizer.vocoder.infer(mel)
            save_wav(os.path.join(output_dir, f'{file_name}.wav'), audio,
                     hparams.sampling_rate)
    return predictions


def generate_mel_specs(synthesizer, sentences, file_names, speaker_ids,
                       output_dir, hparams, dur_factors=None,
                       energy_factors=None, pitch_factors=None, batch_size=1,
                       get_time_perf=False, external_prosody=None,
                       source_stats=None, alpha_dur=1.0, alpha_pitch=1.0,
                       alpha_energy=1.0, external_embeddings=None,
                       external_accent_emb=None, save_outputs=True):
    """Synthesis over all sentences in batches of ``batch_size`` (default
    1, each utterance vocoded on its own), with the RTF accounting under
    ``get_time_perf``: ``predictions['__rtf__']`` is the audio seconds
    made per second of host time over the batches."""
    n = len(sentences)
    dur_factors = dur_factors or [None] * n
    energy_factors = energy_factors or [None] * n
    pitch_factors = pitch_factors if pitch_factors is not None \
        else ['add', [None] * n]
    pitch_transform = pitch_factors[0].lower()
    pitch_factors = pitch_factors[1]
    if pitch_transform not in ('add', 'multiply'):
        raise ValueError(f'pitch transform {pitch_transform!r}: add or '
                         'multiply')
    for lst in (file_names, speaker_ids, dur_factors, energy_factors,
                pitch_factors) + ((external_prosody,) if external_prosody
                                  is not None else ()):
        if len(lst) != n:
            raise ValueError(f'{len(lst)} entries for {n} sentences')

    os.makedirs(output_dir, exist_ok=True)
    predictions, time_per_batch = {}, []
    chunks = list(zip(
        chunker(sentences, batch_size), chunker(dur_factors, batch_size),
        chunker(energy_factors, batch_size), chunker(pitch_factors, batch_size),
        chunker(speaker_ids, batch_size), chunker(list(file_names), batch_size)))
    ext_chunks = list(chunker(external_prosody, batch_size)) \
        if external_prosody is not None else [None] * len(chunks)
    emb_chunks = list(chunker(external_embeddings, batch_size)) \
        if isinstance(external_embeddings, list) else \
        [external_embeddings] * len(chunks)
    acc_chunks = list(chunker(external_accent_emb, batch_size)) \
        if isinstance(external_accent_emb, list) else \
        [external_accent_emb] * len(chunks)

    for idx, (sent_c, dur_c, nrg_c, f0_c, spk_c, fn_c) in enumerate(chunks):
        begin = time.time() if get_time_perf else None
        batch_preds = generate_batch_mel_specs(
            synthesizer, sent_c, dur_c, nrg_c, f0_c, pitch_transform,
            spk_c, list(fn_c), output_dir, hparams,
            batch_external_prosody=ext_chunks[idx], source_stats=source_stats,
            alpha_dur=alpha_dur, alpha_pitch=alpha_pitch,
            alpha_energy=alpha_energy,
            external_embeddings=np.asarray(emb_chunks[idx])
            if emb_chunks[idx] is not None else None,
            external_accent_emb=np.asarray(acc_chunks[idx])
            if acc_chunks[idx] is not None else None,
            save_outputs=save_outputs)
        predictions.update(batch_preds)
        if get_time_perf:
            time_per_batch.append(time.time() - begin)

    if get_time_perf:
        durations = []
        for pred in predictions.values():
            nb_frames = pred[4].shape[1]
            nb_wav_samples = (nb_frames - 1) * hparams.hop_length \
                + hparams.filter_length
            if hparams.centered:
                nb_wav_samples -= 2 * int(hparams.filter_length / 2)
            durations.append(nb_wav_samples / hparams.sampling_rate)
        total_audio, total_time = sum(durations), sum(time_per_batch)
        _logger.info(f'{len(predictions)} sentences ({total_audio:.2f}s) '
                     f'generated in {total_time:.2f}s')
        _logger.info(f'DaftExprt RTF: {total_audio / max(total_time, 1e-9):.2f}')
        predictions['__rtf__'] = total_audio / max(total_time, 1e-9)
    return predictions


def extract_reference_parameters(audio_ref, output_dir, hparams,
                                 ref_name=None, pitch_extractor=None,
                                 device=None):
    """Audio -> {energy, pitch, mel_spec} npz for reference conditioning,
    returns its path (an existing npz is kept). Mel and energy run on
    ``device`` (default cuda; raises without CUDA unless ``device='cpu'``);
    ``pitch_extractor(wav, fs, hparams)`` defaults to ``extract_pitch``
    ('auto': the native tracker if built, else the card's)."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    file_name = ref_name if ref_name is not None else \
        os.path.basename(audio_ref).replace('.wav', '')
    ref_file = os.path.join(output_dir, f'{file_name}.npz')
    if os.path.isfile(ref_file):
        return ref_file
    wav, fs = load_wav(audio_ref, target_sr=hparams.sampling_rate)
    if pitch_extractor is None:
        pitch_extractor = functools.partial(extract_pitch, device=dev)
    pitch = pitch_extractor(wav, fs, hparams)
    mel_spec, energy = MelExtractor(hparams, device=dev).with_energy(wav)
    min_len = min(len(pitch), len(energy), mel_spec.shape[1])
    pitch, energy = pitch[:min_len], energy[:min_len]
    mel_spec = mel_spec[:, :min_len]
    np.savez(ref_file, energy=energy, pitch=pitch, mel_spec=mel_spec)
    return ref_file
