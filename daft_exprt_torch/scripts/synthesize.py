"""Synthesis CLI (the port's ``scripts/synthesize.py``).

    python -m daft_exprt_torch.scripts.synthesize -out OUT -chk CKPT \
        [--int8_vocoder | --fast_vocoder] [--vocoder_checkpoint G] ...

Symbol-prosody file parsing (tuple-list and 4-array forms), new-speaker
stats from JSON or a wav directory, zero-shot ECAPA speaker embeddings
from wavs, accent embeddings through the model's accent encoder,
duration/pitch/energy exaggeration and explicit control factors, HiFi-GAN
(float32, ``--fast_vocoder`` bf16, ``--int8_vocoder``: static with the
style bank's calibration mels, dynamic without) or Griffin-Lim waveforms,
buzz reduction, RTF, and prosody-comparison plots with Pearson
correlation. The acoustic checkpoint is the port's own or the reference
implementation's ``.pt``, told apart by content. Figures need matplotlib
and are skipped without it. Nothing is downloaded: the HiFi-GAN vocoder
needs ``--vocoder_checkpoint`` (a reference generator state dict).
"""
import argparse
import ast
import json
import logging
import os
import time

import numpy as np
import torch

from daft_exprt_torch.scripts._cli import (
    PROJECT_ROOT, add_device_flag, parse_args,
)

_logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# symbol prosody file parsing
# ----------------------------------------------------------------------

def _coerce_split_arrays_to_tuples(payload, line_idx):
    """4-array form: [symbols, durations, pitch, energy]."""
    if (isinstance(payload, (list, tuple)) and len(payload) == 4
            and all(isinstance(x, (list, tuple)) for x in payload)):
        symbols, durations, pitch, energy = payload
        if len(symbols) == len(durations) == len(pitch) == len(energy):
            return list(zip(symbols, durations, pitch, energy))
    raise ValueError(f'Line {line_idx}: Expected a list of 4-tuples or '
                     f'4 parallel arrays.')


def parse_symbol_prosody_file(prosody_file, hparams):
    """Load (symbol, dur_frames, pitch, energy) tuples: returns
    (sentences, file names, external prosody dicts)."""
    if not os.path.isfile(prosody_file):
        raise FileNotFoundError(prosody_file)
    sentences, file_names, external_prosody = [], [], []
    with open(prosody_file, 'r', encoding='utf-8') as f:
        for line_idx, raw_line in enumerate(f, 1):
            line = raw_line.strip()
            if not line or line.startswith('#'):
                continue
            source_hint, payload = None, line
            if '|' in line:
                maybe_source, remainder = line.split('|', 1)
                trimmed = remainder.lstrip()
                if trimmed.startswith('[') or trimmed.startswith('('):
                    source_hint = maybe_source.strip()
                    payload = trimmed
            try:
                parsed = ast.literal_eval(payload)
            except (SyntaxError, ValueError) as exc:
                raise ValueError(f'Line {line_idx}: unparsable symbol '
                                 f'prosody: {exc}')
            if isinstance(parsed, (list, tuple)) and parsed and all(
                    isinstance(e, (list, tuple)) and len(e) == 4
                    for e in parsed):
                tuples = parsed
            else:
                tuples = _coerce_split_arrays_to_tuples(parsed, line_idx)
            symbols, durations, pitch, energy = [], [], [], []
            for symbol, dur, p, e in tuples:
                symbol = str(symbol)
                if symbol not in hparams.symbols:
                    raise ValueError(f'Line {line_idx}: symbol "{symbol}" '
                                     f'not in the symbol set')
                symbols.append(symbol)
                durations.append(int(dur))
                pitch.append(float(p))
                energy.append(float(e))
            if not symbols:
                raise ValueError(f'Line {line_idx}: empty symbol list')
            base = (os.path.splitext(os.path.basename(source_hint))[0]
                    if source_hint
                    else f'symbol_prosody_line{len(file_names)}')
            sentences.append(list(symbols))
            file_names.append(base)
            external_prosody.append({'symbols': list(symbols),
                                     'durations_frames': durations,
                                     'pitch': pitch, 'energy': energy})
    if not sentences:
        raise ValueError(f'"{prosody_file}" has no symbol prosody entries')
    return sentences, file_names, external_prosody


# ----------------------------------------------------------------------
# speaker stats / embeddings
# ----------------------------------------------------------------------

def _wav_files(wav_dir):
    return [f for f in sorted(os.listdir(wav_dir)) if f.endswith('.wav')]


def stats_from_wav_dir(wav_dir, hparams, pitch_method='auto', device=None):
    """Voiced-pitch and non-zero-energy mean and std over a directory of
    wavs; mel, energy and the pitch tracker run on ``device`` (default
    cuda)."""
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.ops.mel import MelExtractor

    extractor = MelExtractor(hparams, device=device)
    pitch_vals, energy_vals = [], []
    for wav_file in _wav_files(wav_dir):
        wav, fs = load_wav(os.path.join(wav_dir, wav_file),
                           target_sr=hparams.sampling_rate)
        pitch = extract_pitch(wav, fs, hparams, method=pitch_method,
                              device=device)
        pitch_vals.extend(pitch[pitch > 0])
        energy = extractor.with_energy(wav)[1]
        energy_vals.extend(energy[energy > 0])
    if not pitch_vals or not energy_vals:
        raise ValueError(f'no usable audio in {wav_dir}')
    return {
        'pitch': {'mean': float(np.mean(pitch_vals)),
                  'std': float(np.std(pitch_vals)) or 1.0},
        'energy': {'mean': float(np.mean(energy_vals)),
                   'std': float(np.std(energy_vals)) or 1.0},
    }


def accent_embedding_from_wav_dir(model, wav_dir, hparams,
                                  pitch_method='auto'):
    """The accent encoder's embedding averaged over a directory of
    reference wavs, on the model's device; each reference padded to a
    frame bucket (``generate._round_to_bucket``) with the mel floor."""
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.generate import _round_to_bucket
    from daft_exprt_torch.ops.mel import MelExtractor

    device = next(model.parameters()).device
    extractor = MelExtractor(hparams, device=device)
    embs = []
    for wav_file in _wav_files(wav_dir):
        wav, fs = load_wav(os.path.join(wav_dir, wav_file),
                           target_sr=hparams.sampling_rate)
        mel, energy = extractor.with_energy(wav)
        pitch = extract_pitch(wav, fs, hparams, method=pitch_method,
                              device=device)
        T = min(mel.shape[1], len(energy), len(pitch))
        T_pad = _round_to_bucket(T, hparams.frame_buckets)

        def pad_t(x):
            return torch.as_tensor(np.pad(x[:T], (0, T_pad - T))[None],
                                   dtype=torch.float32, device=device)
        mel_pad = np.full((1, mel.shape[0], T_pad), np.log(1e-5),
                          dtype=np.float32)
        mel_pad[0, :, :T] = mel[:, :T]
        with torch.no_grad():
            emb = model.encode_accent(
                pad_t(energy), pad_t(pitch),
                torch.as_tensor(mel_pad, device=device),
                torch.tensor([T], device=device))
        embs.append(emb.float().cpu().numpy()[0])
    if not embs:
        raise ValueError(f'no wavs in {wav_dir}')
    return np.mean(np.stack(embs), axis=0)


# ----------------------------------------------------------------------
# checkpoint loading
# ----------------------------------------------------------------------

def load_model_for_synthesis(checkpoint_path, config_overrides=None,
                             device=None, output_directory=None):
    """An acoustic checkpoint (the port's own, or a reference ``.pt``; by
    content) -> (model in eval mode on ``device``, hparams, extra), the
    training config rebuilt from the checkpoint; ``extra`` carries the
    checkpoint's auxiliary payloads (memorized embeddings), {} for a
    reference file. A config without an ``output_directory`` gets
    ``output_directory`` (default: the checkpoint's own directory), where
    HyperParams reads ``stats.json`` when the config has no stats."""
    from daft_exprt_torch import checkpoint as ckpt
    from daft_exprt_torch.hparams import HyperParams
    from daft_exprt_torch.models.daft_exprt import DaftExprt

    state, config_params, extra, _ = ckpt.load_acoustic_checkpoint(
        checkpoint_path)
    config_params.update(config_overrides or {})
    for drop in ('n_symbols',):
        config_params.pop(drop, None)
    config_params.setdefault('training_files', 'unused')
    config_params.setdefault('validation_files', 'unused')
    config_params.setdefault('output_directory', output_directory or
                             os.path.dirname(os.path.abspath(checkpoint_path)))
    config_params.setdefault('language', 'english')
    config_params.setdefault('speakers', ['speaker_0'])
    hparams = HyperParams(verbose=False, **config_params)
    model = DaftExprt.from_hparams(hparams, device=device)
    model.load_state_dict(state, strict=True)
    return model.eval(), hparams, extra


# ----------------------------------------------------------------------
# buzz reduction
# ----------------------------------------------------------------------

def reduce_buzz(mel):
    """Light temporal smoothing + gentle high-bin attenuation before
    vocoding."""
    smoothed = mel.copy()
    smoothed[:, 1:-1] = (mel[:, :-2] + 2 * mel[:, 1:-1] + mel[:, 2:]) / 4.0
    n_mels = mel.shape[0]
    rolloff = np.ones((n_mels, 1))
    rolloff[-8:, 0] = np.linspace(1.0, 0.7, 8)
    return smoothed * rolloff + (1 - rolloff) * np.log(1e-5)


# ----------------------------------------------------------------------
# prosody comparison plots
# ----------------------------------------------------------------------

def compute_corr(ref_vals, gen_vals):
    """Pearson r over jointly valid entries of the common prefix (None
    with fewer than two or a constant side)."""
    ref = np.asarray(ref_vals, dtype=np.float64)
    gen = np.asarray(gen_vals, dtype=np.float64)
    n = min(len(ref), len(gen))
    ref, gen = ref[:n], gen[:n]
    valid = np.isfinite(ref) & np.isfinite(gen)
    if valid.sum() < 2:
        return None
    ref, gen = ref[valid], gen[valid]
    if ref.std() == 0 or gen.std() == 0:
        return None
    return float(np.corrcoef(ref, gen)[0, 1])


def plot_prosody_curves(symbols, ref_pitch, gen_pitch, ref_energy,
                        gen_energy, filename):
    """Reference-vs-generated symbol prosody overlay with Pearson r."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(14, 8))
    for ax, (ref, gen, label) in zip(axes, [
            (ref_pitch, gen_pitch, 'pitch'),
            (ref_energy, gen_energy, 'energy')]):
        r = compute_corr(ref, gen)
        ax.plot(ref, label='Reference', marker='x')
        ax.plot(gen, label='Generated', marker='o')
        ax.set_xticks(range(len(symbols)))
        ax.set_xticklabels(symbols, rotation=90)
        title = f'Symbol {label}'
        if r is not None:
            title += f' (r={r:.2f})'
        ax.set_title(title)
        ax.legend()
    fig.tight_layout()
    fig.savefig(filename, dpi=100)
    plt.close(fig)
    return filename


# ----------------------------------------------------------------------
# main
# ----------------------------------------------------------------------

def _style_bank(bank):
    """(prosody file, spk_emb.npy, wav dir) of a style bank, each None
    where the bank has none."""
    bank_prosody = bank_spk_emb = bank_wavs = None
    if bank and os.path.isdir(bank):
        prosody_files = sorted(
            f for f in os.listdir(bank) if f.endswith('.prosody'))
        if prosody_files:
            bank_prosody = os.path.join(bank, prosody_files[0])
        if os.path.isfile(os.path.join(bank, 'spk_emb.npy')):
            bank_spk_emb = os.path.join(bank, 'spk_emb.npy')
        if any(f.endswith('.wav') for f in os.listdir(bank)):
            bank_wavs = bank
    return bank_prosody, bank_spk_emb, bank_wavs


def calibration_mels(bank_wavs, hparams, device=None):
    """The int8-static tier's calibration: the mels of the style bank's
    first two wavs, cropped to the shorter, (2, n_mels, T)."""
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.ops.mel import MelExtractor

    extractor = MelExtractor(hparams, device=device)
    mels = [extractor(load_wav(os.path.join(bank_wavs, f),
                               target_sr=hparams.sampling_rate)[0])
            for f in _wav_files(bank_wavs)[:2]]
    if not mels:
        return None
    T_min = min(m.shape[1] for m in mels)
    return np.stack([m[:, :T_min] for m in mels])


def synthesize(args, dur_factor=None, pitch_factor=None,
               pitch_transform='add', get_time_perf=False):
    """One synthesis run of the CLI's ``args`` on ``args.device``; returns
    generate_mel_specs' predictions (keyed '{name}_spk_{speaker id}')."""
    from daft_exprt_torch.frontend.audio import save_wav
    from daft_exprt_torch.generate import Synthesizer, generate_mel_specs
    from daft_exprt_torch.models.hifigan import load_hifigan_vocoder
    from daft_exprt_torch.utils.plots import have_matplotlib, plot_2d_data

    device = getattr(args, 'device', None)
    overrides = json.loads(args.config_overrides) \
        if args.config_overrides else {}
    model, hparams, ckpt_extra = load_model_for_synthesis(
        args.checkpoint, overrides, device=device,
        output_directory=args.output_dir)

    # style-bank defaults: a bank built by make_style_bank carries
    # *.prosody / spk_emb.npy / wavs, making synthesis runnable with just a
    # checkpoint and an output directory
    bank = getattr(args, 'style_bank', '') or ''
    bank_prosody, bank_spk_emb, bank_wavs = _style_bank(bank)

    prosody_file = args.symbol_prosody_file or bank_prosody
    if not prosody_file:
        raise ValueError(
            'provide --symbol_prosody_file, or populate the style bank '
            f'("{bank or "--style_bank"}") with a *.prosody file via '
            'make_style_bank --features_dir (the prosody predictor is '
            'external — see README)')
    if prosody_file is bank_prosody:
        _logger.info(f'using style-bank prosody: {prosody_file}')
    sentences, file_names, external_prosody = parse_symbol_prosody_file(
        prosody_file, hparams)
    n = len(sentences)
    speaker_ids = [args.speaker_id] * n

    source_stats = None
    if args.new_speaker_stats:
        if os.path.isdir(args.new_speaker_stats):
            source_stats = stats_from_wav_dir(args.new_speaker_stats,
                                              hparams, device=device)
        else:
            with open(args.new_speaker_stats) as f:
                source_stats = json.load(f)

    if args.spk_emb_audios_dir:
        from daft_exprt_torch.frontend.ecapa import (
            average_embedding_from_wav_dir,
        )
        spk_emb = average_embedding_from_wav_dir(args.spk_emb_audios_dir,
                                                 device=device)
    elif args.spk_emb_file:
        spk_emb = np.load(args.spk_emb_file).reshape(-1).astype(np.float32)
    elif 'memorized_spk_emb' in ckpt_extra:
        # adapted checkpoints carry the speaker embedding memorized by
        # adapt_speaker
        spk_emb = np.asarray(ckpt_extra['memorized_spk_emb'],
                             dtype=np.float32).reshape(-1)
        _logger.info('using memorized speaker embedding from the checkpoint')
    elif bank_spk_emb:
        spk_emb = np.load(bank_spk_emb).reshape(-1).astype(np.float32)
        _logger.info(f'using style-bank speaker embedding: {bank_spk_emb}')
    else:
        raise ValueError('provide --spk_emb_audios_dir or --spk_emb_file, '
                         'use an adapted checkpoint with a memorized '
                         'speaker embedding, or add spk_emb.npy to the '
                         'style bank (make_style_bank)')

    if args.accent_emb_audios_dir:
        accent_emb = accent_embedding_from_wav_dir(
            model, args.accent_emb_audios_dir, hparams)
    elif args.accent_emb_file:
        accent_emb = np.load(args.accent_emb_file).reshape(-1).astype(
            np.float32)
    elif 'memorized_accent_emb' in ckpt_extra:
        accent_emb = np.asarray(ckpt_extra['memorized_accent_emb'],
                                dtype=np.float32).reshape(-1)
        _logger.info('using memorized accent embedding from the checkpoint')
    elif args.neutralize_prosody:
        accent_emb = np.zeros(model.hidden_dim, dtype=np.float32)
    elif bank_wavs:
        accent_emb = accent_embedding_from_wav_dir(model, bank_wavs,
                                                   hparams)
        _logger.info(f'using style-bank accent references: {bank_wavs}')
    else:
        raise ValueError('provide --accent_emb_audios_dir, '
                         '--accent_emb_file, --neutralize_prosody, an '
                         'accent-adapted checkpoint (memorized_accent_emb),'
                         ' or add reference wavs to the style bank')

    vocoder = None
    if not args.use_griffin_lim:
        tier = 'int8' if getattr(args, 'int8_vocoder', False) \
            else bool(getattr(args, 'fast_vocoder', False))
        # int8 tier: static per-channel act scales calibrated on the
        # style-bank reference audio where there is some, else the dynamic
        # tier (per-tile scales at run time)
        cal_mels = None
        if tier == 'int8' and bank_wavs:
            cal_mels = calibration_mels(bank_wavs, hparams, device=device)
            if cal_mels is not None:
                _logger.info(f'int8 static scales calibrated on '
                             f'{len(cal_mels)} style-bank mels')
        vocoder = load_hifigan_vocoder(args.vocoder_checkpoint or None,
                                       fast=tier,
                                       int8_calibration_mels=cal_mels,
                                       device=device)

    synthesizer = Synthesizer(model, hparams, vocoder=vocoder)

    dur_factors = None
    pitch_factors_list = None
    if dur_factor is not None:
        dur_factors = [[dur_factor] * len(s) for s in sentences]
    if pitch_factor is not None:
        pitch_factors_list = [pitch_transform,
                              [[pitch_factor] * len(s) for s in sentences]]

    os.makedirs(args.output_dir, exist_ok=True)
    predictions = generate_mel_specs(
        synthesizer, sentences, list(file_names), speaker_ids,
        args.output_dir, hparams, dur_factors=dur_factors,
        pitch_factors=pitch_factors_list, batch_size=args.batch_size,
        get_time_perf=get_time_perf, external_prosody=external_prosody,
        source_stats=source_stats, alpha_dur=args.alpha_dur,
        alpha_pitch=args.alpha_pitch, alpha_energy=args.alpha_energy,
        external_embeddings=spk_emb, external_accent_emb=accent_emb,
        save_outputs=not args.use_griffin_lim)
    rtf = predictions.pop('__rtf__', None)
    plots = have_matplotlib()

    if args.use_griffin_lim:
        from daft_exprt_torch.frontend.griffin_lim import (
            griffin_lim_reconstruction_from_mel_spec,
        )
        for name, (_, _, _, _, mel, weight) in predictions.items():
            np.savez(os.path.join(args.output_dir, f'{name}.npz'),
                     mel_spec=mel)
            if plots:
                plot_2d_data(data=(mel, weight),
                             x_labels=('Mel-Spec Prediction', 'Alignments'),
                             filename=os.path.join(args.output_dir,
                                                   f'{name}.png'))
            wav = griffin_lim_reconstruction_from_mel_spec(mel, hparams,
                                                           device=device)
            save_wav(os.path.join(args.output_dir, f'{name}.wav'), wav,
                     hparams.sampling_rate)
    elif args.reduce_buzz:
        for name, (_, _, _, _, mel, _) in predictions.items():
            audio = vocoder.infer(reduce_buzz(mel))
            save_wav(os.path.join(args.output_dir, f'{name}_smooth.wav'),
                     audio, hparams.sampling_rate)

    # prosody comparison plots vs the input prosody file. predictions are
    # keyed '{name}_spk_{sid}' and come back sorted by length: pair by
    # name, not by position
    prosody_by_name = {
        f'{base}_spk_{sid}': prosody
        for base, sid, prosody in zip(file_names, speaker_ids,
                                      external_prosody)}
    if len(prosody_by_name) != len(file_names):
        raise ValueError(
            'duplicate utterance names in the prosody file — the '
            'prosody-comparison pairing would silently mispair. Rebuild '
            'the style bank (make_style_bank uniquifies names).')
    if plots:
        for name, (dur, dur_i, nrg, f0, mel, w) in predictions.items():
            prosody = prosody_by_name[name]
            plot_prosody_curves(
                prosody['symbols'], prosody['pitch'],
                f0[:len(prosody['pitch'])], prosody['energy'],
                nrg[:len(prosody['energy'])],
                os.path.join(args.output_dir, f'{name}_prosody.png'))
    else:
        _logger.warning('matplotlib is not installed: no prosody plots')
    if rtf is not None:
        _logger.info(f'RTF: {rtf:.2f}')
    return predictions


def build_parser():
    parser = argparse.ArgumentParser(
        description='synthesize sentences with daft_exprt_torch')
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('-chk', '--checkpoint', type=str, required=True)
    parser.add_argument('-spf', '--symbol_prosody_file', type=str,
                        default='',
                        help='(symbol, duration, pitch, energy) tuples file '
                             '(the prosody predictor is external); defaults '
                             'to the style bank\'s *.prosody file')
    parser.add_argument('-sb', '--style_bank', type=str,
                        default=os.path.join(PROJECT_ROOT, 'scripts',
                                             'style_bank', 'english'),
                        help='directory with reference material for the '
                             'zero-argument demo: *.prosody, spk_emb.npy, '
                             'reference wavs (build with make_style_bank)')
    parser.add_argument('-sid', '--speaker_id', type=int, default=0)
    parser.add_argument('--config_overrides', type=str, default='')
    parser.add_argument('--use_griffin_lim', action='store_true')
    parser.add_argument('--fast_vocoder', action='store_true',
                        help='bf16 vocoder on the fused MRF kernels')
    parser.add_argument('--int8_vocoder', action='store_true',
                        help='int8 vocoder: static act scales calibrated '
                             'on the style bank\'s wavs, dynamic without')
    parser.add_argument('--vocoder_checkpoint', type=str, default='')
    parser.add_argument('--reduce_buzz', action='store_true')
    parser.add_argument('-bs', '--batch_size', type=int, default=50)
    parser.add_argument('-rtf', '--real_time_factor', action='store_true')
    parser.add_argument('-ctrl', '--control', action='store_true')
    parser.add_argument('--new_speaker_stats', type=str, default='')
    parser.add_argument('--neutralize_prosody', action='store_true')
    parser.add_argument('--alpha_dur', type=float, default=1.0)
    parser.add_argument('--alpha_pitch', type=float, default=1.0)
    parser.add_argument('--alpha_energy', type=float, default=1.0)
    parser.add_argument('--spk_emb_audios_dir', type=str, default='')
    parser.add_argument('--spk_emb_file', type=str, default='')
    parser.add_argument('--accent_emb_audios_dir', type=str, default='')
    parser.add_argument('--accent_emb_file', type=str, default='')
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Run the CLI; returns the predictions of its last synthesis run."""
    args = parse_args(build_parser(), argv)
    if args.real_time_factor:
        synthesize(args, get_time_perf=True)
        time.sleep(1)
    if args.control:
        # sentence-level control demo: slower + 50 Hz shift
        return synthesize(args, dur_factor=1.25, pitch_factor=50,
                          pitch_transform='add')
    return synthesize(args)


if __name__ == '__main__':
    main()
