"""Accent-conversion evaluation harness (the port's
``scripts/evaluation/compute_wer_and_accent_metrics.py``).

    python -m \
        daft_exprt_torch.scripts.evaluation.compute_wer_and_accent_metrics \
        -m MANIFEST -out OUT [-chk CKPT] [--wer] [--accent_id] [--nisqa] \
        [--whisper_dtw] [--device cuda]

The manifest's lines are ``generated_wav|transcript[|reference_wav]``.
Native metrics, on ``--device``: per-utterance pitch std (semitones),
energy nPVI and duration nPVI (``prosody_metrics``: the pitch tracker,
the log-mel and its frame energy) and, with a checkpoint and a reference
wav, the cosine distance between the accent encoder's embeddings of the
two audios. Gated externals, loaded lazily and skipped with a warning when
absent: WER through Whisper, the SpeechBrain CommonAccent classifier, the
Whisper-encoder DTW distance and NISQA. Writes ``evaluation_report.json``
and, where matplotlib imports, a histogram per metric (skipped without it,
with a warning).
"""
import argparse
import json
import logging
import os
import re
import tempfile

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)

COMMON_ACCENT_LABELS = [
    'african', 'australia', 'bermuda', 'canada', 'england', 'hongkong',
    'indian', 'ireland', 'malaysia', 'newzealand', 'philippines',
    'scotland', 'singapore', 'southatlandtic', 'us', 'wales',
]


# ----------------------------------------------------------------------
# text normalization + WER
# ----------------------------------------------------------------------

def normalize_for_wer(text):
    text = text.lower()
    text = re.sub(r"[^a-z' ]", ' ', text)
    return re.sub(r'\s+', ' ', text).strip()


def word_error_rate(reference, hypothesis):
    """Levenshtein WER over the normalized words."""
    ref = normalize_for_wer(reference).split()
    hyp = normalize_for_wer(hypothesis).split()
    if not ref:
        return 0.0 if not hyp else 1.0
    d = np.zeros((len(ref) + 1, len(hyp) + 1), dtype=np.int32)
    d[:, 0] = np.arange(len(ref) + 1)
    d[0, :] = np.arange(len(hyp) + 1)
    for i in range(1, len(ref) + 1):
        for j in range(1, len(hyp) + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + cost)
    return float(d[-1, -1]) / len(ref)


def load_whisper(model_size='base'):
    try:
        import whisper
        return whisper.load_model(model_size)
    except ImportError:
        _logger.warning('whisper not installed: skipping WER/DTW metrics')
        return None


def load_accent_classifier(device='cpu'):
    try:
        from speechbrain.pretrained.interfaces import foreign_class
        return foreign_class(
            source='Jzuluaga/accent-id-commonaccent_ecapa',
            pymodule_file='custom_interface.py',
            classname='CustomEncoderWav2vec2Classifier',
            run_opts={'device': device})
    except Exception as exc:                         # noqa: BLE001
        _logger.warning(f'accent classifier unavailable ({exc}): skipping')
        return None


def load_nisqa():
    try:
        from nisqa.NISQA_model import nisqaModel
        return nisqaModel
    except ImportError:
        _logger.warning('NISQA not installed: skipping MOS metrics')
        return None


# ----------------------------------------------------------------------
# prosody metrics (native)
# ----------------------------------------------------------------------

def npvi(values):
    """Normalized pairwise variability index of the positive values (None
    with fewer than two)."""
    v = np.asarray([x for x in values if x > 0], dtype=np.float64)
    if len(v) < 2:
        return None
    diffs = np.abs(np.diff(v)) / ((v[:-1] + v[1:]) / 2.0)
    return float(100.0 * np.mean(diffs))


def prosody_metrics(wav, fs, hparams, pitch_method='auto', device=None):
    """Per-utterance pitch std (semitones), energy nPVI and duration nPVI
    (syllable proxy: voiced-run durations); mel, energy and pitch on
    ``device`` (default cuda)."""
    from daft_exprt_torch.frontend.pitch import extract_pitch
    from daft_exprt_torch.ops.mel import MelExtractor

    pitch = extract_pitch(wav, fs, hparams, method=pitch_method,
                          device=device)
    voiced = pitch[pitch > 0]
    pitch_std = float(np.std(voiced * 12 / np.log(2))) if len(voiced) > 1 \
        else None

    energy = MelExtractor(hparams, device=device).with_energy(wav)[1]
    energy_npvi = npvi(energy)

    is_voiced = (pitch > 0).astype(int)
    changes = np.diff(np.concatenate([[0], is_voiced, [0]]))
    starts = np.where(changes == 1)[0]
    ends = np.where(changes == -1)[0]
    run_durs = (ends - starts).astype(np.float64)
    duration_npvi = npvi(run_durs)
    return {'pitch_std_semitones': pitch_std, 'energy_npvi': energy_npvi,
            'duration_npvi': duration_npvi}


def accent_embedding_cosine(model, hparams, wav_a, wav_b,
                            pitch_method='auto'):
    """Cosine distance between the accent encoder's embeddings of two
    audios (each through ``synthesize.accent_embedding_from_wav_dir``, on
    the model's device)."""
    from daft_exprt_torch.frontend.audio import save_wav
    from daft_exprt_torch.scripts.synthesize import (
        accent_embedding_from_wav_dir,
    )

    embs = []
    for wav in (wav_a, wav_b):
        with tempfile.TemporaryDirectory() as td:
            save_wav(os.path.join(td, 'x.wav'), wav, hparams.sampling_rate)
            embs.append(accent_embedding_from_wav_dir(
                model, td, hparams, pitch_method=pitch_method))
    a, b = embs
    cos = float(np.dot(a, b)
                / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    return 1.0 - cos


def dtw_distance(feat_a, feat_b):
    """Cosine-metric DTW over feature sequences, normalized by the
    warping-path length (librosa.sequence.dtw(metric='cosine') and
    total_cost / len(wp)); the local costs are one (n, m) matmul of
    unit-normalized rows."""
    a = np.asarray(feat_a, dtype=np.float64)
    b = np.asarray(feat_b, dtype=np.float64)
    a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
    dist = 1.0 - a @ b.T                              # (n, m) cosine dist
    n, m = dist.shape
    cost = np.full((n + 1, m + 1), np.inf)
    cost[0, 0] = 0.0
    for i in range(1, n + 1):
        row = cost[i]
        prev = cost[i - 1]
        d = dist[i - 1]
        acc = np.inf
        for j in range(1, m + 1):
            acc = d[j - 1] + min(prev[j], prev[j - 1], acc)
            row[j] = acc
    # backtrack for the warping-path length
    i, j, steps = n, m, 0
    while i > 1 or j > 1:
        moves = ((cost[i - 1, j - 1], i - 1, j - 1),
                 (cost[i - 1, j], i - 1, j),
                 (cost[i, j - 1], i, j - 1))
        _, i, j = min(moves)
        steps += 1
    return float(cost[n, m] / max(steps + 1, 1))


def whisper_encoder_features(whisper_model, wav_path):
    """Whisper-encoder feature sequence of a file, for the DTW distance."""
    import torch
    import whisper
    audio = whisper.load_audio(wav_path)
    audio = whisper.pad_or_trim(audio)
    mel = whisper.log_mel_spectrogram(
        audio, n_mels=whisper_model.dims.n_mels).to(whisper_model.device)
    with torch.no_grad():
        feats = whisper_model.encoder(mel[None])
    return feats[0].cpu().numpy()


def nisqa_scores(nisqa_cls, wav_path, checkpoint='nisqa.tar'):
    """NISQA MOS/NOI/DIS/COL/LOUD of one file; raises on failure, so that
    the caller disables the metric after the first error."""
    model = nisqa_cls({'mode': 'predict_file',
                       'pretrained_model': checkpoint, 'deg': wav_path,
                       'ms_channel': None, 'output_dir': None})
    df = model.predict()
    row = df.iloc[0]
    return {f'nisqa_{k.lower()}': float(row[c])
            for k, c in (('MOS', 'mos_pred'), ('NOI', 'noi_pred'),
                         ('DIS', 'dis_pred'), ('COL', 'col_pred'),
                         ('LOUD', 'loud_pred')) if c in df.columns}


# ----------------------------------------------------------------------
# main harness
# ----------------------------------------------------------------------

def _histograms(per_utt, output_dir):
    from daft_exprt_torch.utils.plots import have_matplotlib
    if not have_matplotlib():
        _logger.warning('matplotlib not installed: no histograms')
        return
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for key in ('pitch_std_semitones', 'energy_npvi', 'duration_npvi',
                'wer'):
        vals = [r[key] for r in per_utt if r.get(key) is not None]
        if not vals:
            continue
        fig, ax = plt.subplots()
        ax.hist(vals, bins=20)
        ax.set_title(key)
        fig.savefig(os.path.join(output_dir, f'hist_{key}.png'), dpi=100)
        plt.close(fig)


def evaluate(args):
    """The report (also written to ``evaluation_report.json``)."""
    from daft_exprt_torch.frontend.audio import load_wav
    from daft_exprt_torch.hparams import HyperParams

    hparams = HyperParams(verbose=False, training_files='unused',
                          validation_files='unused',
                          output_directory=args.output_dir,
                          language='english', speakers=['spk'])
    os.makedirs(args.output_dir, exist_ok=True)

    with open(args.manifest, 'r', encoding='utf-8') as f:
        entries = [line.strip().split('|') for line in f if line.strip()]

    if args.whisper_dtw and not any(len(e) > 2 for e in entries):
        _logger.warning('--whisper_dtw requested but the manifest has no '
                        'reference-wav column (3rd field): no DTW '
                        'distances will be computed')
    whisper_model = load_whisper(args.whisper_model) \
        if (args.wer or args.whisper_dtw) else None
    accent_clf = load_accent_classifier(args.device) if args.accent_id \
        else None
    nisqa_cls = load_nisqa() if args.nisqa else None
    ref_feat_cache = {}        # reference wavs repeat across rows

    model = None
    if args.checkpoint:
        from daft_exprt_torch.scripts.synthesize import (
            load_model_for_synthesis,
        )
        model, hparams, _extra = load_model_for_synthesis(
            args.checkpoint, device=args.device)

    per_utt = []
    for entry in entries:
        gen_path, transcript = entry[0], entry[1]
        ref_path = entry[2] if len(entry) > 2 else None
        wav, fs = load_wav(gen_path, target_sr=hparams.sampling_rate)
        row = {'file': gen_path}
        row.update(prosody_metrics(wav, fs, hparams,
                                   pitch_method=args.pitch_method,
                                   device=args.device))
        if whisper_model is not None and args.wer:
            result = whisper_model.transcribe(gen_path)
            row['wer'] = word_error_rate(transcript, result['text'])
        if nisqa_cls is not None:
            try:
                row.update(nisqa_scores(nisqa_cls, gen_path,
                                        checkpoint=args.nisqa_checkpoint))
            except Exception as exc:                 # noqa: BLE001
                _logger.warning(f'NISQA failed ({exc}): disabling the '
                                'metric for the rest of the run')
                nisqa_cls = None
        if whisper_model is not None and args.whisper_dtw and ref_path:
            try:
                if ref_path not in ref_feat_cache:
                    ref_feat_cache[ref_path] = whisper_encoder_features(
                        whisper_model, ref_path)
                row['whisper_dtw_dist'] = dtw_distance(
                    whisper_encoder_features(whisper_model, gen_path),
                    ref_feat_cache[ref_path])
            except Exception as exc:                 # noqa: BLE001
                _logger.warning(f'whisper DTW failed on {gen_path}: {exc}')
        if accent_clf is not None:
            out_prob, score, index, label = accent_clf.classify_file(gen_path)
            row['accent_label'] = str(label[0]) if hasattr(label, '__len__') \
                else str(label)
            row['accent_confidence'] = float(score)
            if args.target_accent:
                probs = np.asarray(out_prob).reshape(-1)
                if args.target_accent in COMMON_ACCENT_LABELS:
                    row['target_accent_prob'] = float(
                        probs[COMMON_ACCENT_LABELS.index(args.target_accent)])
        if ref_path and model is not None:
            ref_wav, _ = load_wav(ref_path, target_sr=hparams.sampling_rate)
            row['accent_emb_cosine_dist'] = accent_embedding_cosine(
                model, hparams, wav, ref_wav, pitch_method=args.pitch_method)
        per_utt.append(row)
        _logger.info(json.dumps(row))

    def agg(key):
        vals = [r[key] for r in per_utt if r.get(key) is not None]
        return {'mean': float(np.mean(vals)), 'std': float(np.std(vals)),
                'n': len(vals)} if vals else None

    report = {
        'n_utterances': len(per_utt),
        'wer': agg('wer'),
        'pitch_std_semitones': agg('pitch_std_semitones'),
        'energy_npvi': agg('energy_npvi'),
        'duration_npvi': agg('duration_npvi'),
        'accent_confidence': agg('accent_confidence'),
        'target_accent_prob': agg('target_accent_prob'),
        'accent_emb_cosine_dist': agg('accent_emb_cosine_dist'),
        'whisper_dtw_dist': agg('whisper_dtw_dist'),
        'nisqa_mos': agg('nisqa_mos'),
        'nisqa_noi': agg('nisqa_noi'),
        'nisqa_dis': agg('nisqa_dis'),
        'nisqa_col': agg('nisqa_col'),
        'nisqa_loud': agg('nisqa_loud'),
        'per_utterance': per_utt,
    }
    report_path = os.path.join(args.output_dir, 'evaluation_report.json')
    with open(report_path, 'w') as f:
        json.dump(report, f, indent=2)
    _logger.info(f'report written to {report_path}')
    _histograms(per_utt, args.output_dir)
    return report


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-m', '--manifest', type=str, required=True,
                        help='lines: generated_wav|transcript[|reference_wav]')
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('-chk', '--checkpoint', type=str, default='',
                        help='acoustic checkpoint for accent-embedding '
                             'distance')
    parser.add_argument('--wer', action='store_true')
    parser.add_argument('--accent_id', action='store_true')
    parser.add_argument('--nisqa', action='store_true',
                        help='NISQA MOS/NOI/DIS/COL/LOUD (gated import)')
    parser.add_argument('--nisqa_checkpoint', type=str, default='nisqa.tar',
                        help='path to the NISQA pretrained model weights')
    parser.add_argument('--whisper_dtw', action='store_true',
                        help='Whisper-encoder DTW distance to the '
                             'reference wav (manifest column 3)')
    parser.add_argument('--target_accent', type=str, default='')
    parser.add_argument('--whisper_model', type=str, default='base')
    parser.add_argument('--pitch_method', type=str, default='auto')
    add_device_flag(parser)
    return parser


def main(argv=None):
    return evaluate(parse_args(build_parser(), argv))


if __name__ == '__main__':
    main()
