"""Batch synthesis: a closed loop with one batch in flight.

Each batch is a fresh draw of the mix's generator, handed to the port's
``generate.Synthesizer.infer`` (bucket padding, numpy out) and then, whole,
to ``models/hifigan.py::HiFiGanVocoder.infer`` at the configuration's
tier. A batch's latency runs from the inputs handed over to the waveforms
on the host; audio seconds count each utterance's own frames.

The check compares batches of the window, drawn from the seed, with the
plain float32 reference: the utterances' mels, pooled, against the
reference acoustic model's on the same inputs, and each waveform against
the reference generator's on the program's mel (as the tier pads it).
"""
import time
from pathlib import Path

import numpy as np
import torch


def _sync(device):
    if device == 'cuda':
        torch.cuda.synchronize()


def hparams(ctx):
    """The port's HyperParams at the configuration's acoustic settings."""
    from daft_exprt_torch.hparams import HyperParams
    cfg, mix = ctx['config'], ctx['traffic']
    out_dir = Path(ctx['root']) / 'build' / 'portbench'
    hp = HyperParams(verbose=False, training_files='unused',
                     validation_files='unused', output_directory=str(out_dir),
                     language='english',
                     speakers=[f'spk{i}' for i in range(mix['speakers'])],
                     **cfg['acoustic'])
    for key, value in cfg['acoustic'].items():
        if getattr(hp, key) != value:
            raise ValueError(f'hparams {key}: {getattr(hp, key)!r} is not '
                             f'the configuration\'s {value!r}')
    return hp


def setup(ctx):
    from daft_exprt_torch.generate import Synthesizer
    from daft_exprt_torch.models.daft_exprt import DaftExprt
    from daft_exprt_torch.models.hifigan import HiFiGanVocoder
    weights = ctx['module']('weights')
    dev, cfg, mix, seed = ctx['device'], ctx['config'], ctx['traffic'], \
        ctx['seed']
    if dev == 'cuda':
        from daft_exprt_torch.ops import _build
        _build.build()
    hp = hparams(ctx)
    model = DaftExprt.from_hparams(hp, device=dev)
    acoustic_sd = weights.fill_acoustic(model, seed)
    voc_cfg = cfg['vocoder']
    tier = cfg['serve']['vocoder_tier']
    voc_params = weights.generator_params(voc_cfg, seed + 1, dev,
                                          **cfg.get('vocoder_init', {}))
    if tier != 'float32':
        # made in the type they are served in: the bf16 tier computes
        # with bf16 parameters and the int8 tiers pack them
        voc_params = weights.rounded(voc_params, torch.bfloat16)
    synth = Synthesizer(model, hp)
    Gen = ctx['generator'].Utterances
    dims = (hp.n_symbols, hp.external_emb_dim,
            model.accent_encoder.positions.embed_dim, hp.hop_length,
            hp.sampling_rate)
    cal_mels = None
    if tier == 'int8-static':
        cal = Gen(mix, seed, *dims, stream=1).batch()
        mel, _, _ = synth.infer(**cal)
        cal_mels = mel[:cfg['serve']['calibration_utterances']]
    fast = {'float32': False, 'bf16': 'bf16', 'int8-static': 'int8',
            'int8-dynamic': 'int8'}[tier]
    vocoder = HiFiGanVocoder(voc_params, config=voc_cfg, fast=fast,
                             device=dev, int8_calibration_mels=cal_mels)
    state = dict(ctx=ctx, hp=hp, synth=synth, vocoder=vocoder, model=model,
                 acoustic_sd=acoustic_sd, voc_params=voc_params,
                 voc_cfg=voc_cfg, tier=tier, dims=dims, cal_mels=cal_mels,
                 gen=Gen(mix, seed, *dims, stream=3))
    # warm-up: every bucket of symbols and every vocoder length the mix
    # reaches, then a few ordinary draws
    warm = Gen(mix, seed, *dims, stream=2)
    for frames, symbols in mix['warmup_shapes']:
        _one(state, warm.batch(first=(frames, symbols)))
    for _ in range(mix['warmup_batches']):
        _one(state, warm.batch())
    _sync(dev)
    return state


def _one(state, batch):
    t0 = time.perf_counter()
    mel, _, _ = state['synth'].infer(**batch)
    t1 = time.perf_counter()
    wav = state['vocoder'].infer(mel)
    t2 = time.perf_counter()
    return mel, wav, (t0, t1, t2)


def _least_s(state, frames, symbols):
    """The batch's least time at the peaks (frozen counts): the acoustic
    model at its compute precision, the generator at the tier's."""
    counts = _mod(state, 'counts/acoustic')
    gcounts = _mod(state, 'counts/generator')
    peaks = _mod(state, 'counts/peaks')
    hp, cfg = state['hp'], state['ctx']['config']
    acfg = dict(phoneme_encoder=hp.phoneme_encoder,
                frame_decoder=hp.frame_decoder,
                n_mel_channels=hp.n_mel_channels)
    ac = sum(counts.synthesis_ops(int(l), int(f), acfg)
             for l, f in zip(symbols, frames))
    ac_t = peaks.least_seconds({cfg['acoustic']['compute_dtype']: ac})
    voc_ops = gcounts.least_ops([int(f) for f in frames], state['voc_cfg'],
                                state['tier'])
    voc_t = peaks.least_seconds(voc_ops, gcounts.io_bytes(
        [int(f) for f in frames], state['voc_cfg']))
    return ac_t, voc_t


def window(state, seconds):
    gen, mix = state['gen'], state['ctx']['traffic']
    seed = state['ctx']['seed']
    pick = np.random.default_rng([seed, 31337])
    k = mix['check_batches']
    kept, items, failed, attempted = [], [], 0, 0
    hop, sr = state['hp'].hop_length, state['hp'].sampling_rate
    begin = time.perf_counter()
    deadline = begin + seconds
    while True:
        batch = gen.batch()
        mel, wav, (t0, t1, t2) = _one(state, batch)
        frames = batch['durations_int'].sum(axis=1)
        bad = ~np.isfinite(wav.sum(axis=1))
        failed += int(bad.sum())
        attempted += len(frames)
        n = len(items)
        items.append(dict(t0=t0, t1=t1, t2=t2, frames=frames,
                          symbols=batch['input_lengths'].copy(),
                          audio_s=float(frames.sum()) * hop / sr))
        if len(kept) < k:
            kept.append((n, batch, mel, wav))
        else:
            j = int(pick.integers(0, n + 1))
            if j < k:
                kept[j] = (n, batch, mel, wav)
        if t2 >= deadline:
            break
    end = time.perf_counter()
    for it in items:
        it['least_ac_s'], it['least_voc_s'] = _least_s(
            state, it['frames'], it['symbols'])
    state['kept'] = kept
    return dict(kind='synth', window_s=end - begin, items=items,
                begin=begin, marks=[(it['t0'], it['t2'], it['audio_s'])
                                    for it in items],
                least_s=sum(it['least_ac_s'] + it['least_voc_s']
                            for it in items),
                attempted=attempted, failed=failed)


def trace(state, record):
    """Two profiled stretches of ``trace_batches`` fresh batches each: one
    of the device alone (busy time, idle share, device operations), then
    one with the host, each call inside the benchmark's ``acoustic`` and
    ``vocoder`` ranges (the ranges' device time, the idle gaps)."""
    from torch.profiler import record_function
    tracing = _mod(state, 'tracing')
    mix = state['ctx']['traffic']
    gen, dev = state['gen'], state['ctx']['device']
    lean = [gen.batch() for _ in range(mix['trace_batches'])]
    full = [gen.batch() for _ in range(mix['trace_batches'])]

    def plain():
        for batch in lean:
            _one(state, batch)

    def ranged():
        for batch in full:
            with record_function('acoustic'):
                mel, _, _ = state['synth'].infer(**batch)
            with record_function('vocoder'):
                state['vocoder'].infer(mel)

    tr = tracing.two_stretches(plain, ranged, lambda: _sync(dev))
    tr['least_voc_s'] = sum(_least_s(state, b['durations_int'].sum(axis=1),
                                     b['input_lengths'])[1] for b in full)
    tr['batches'] = len(full)
    record['trace'] = tr


def release(state):
    for key in ('synth', 'vocoder', 'model', 'gen'):
        state.pop(key, None)
    if state['ctx']['device'] == 'cuda':
        torch.cuda.empty_cache()


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def reference_outputs(state, batch, mel_prog, acoustic_q=None, vocoder_q=None,
                      block=8):
    """The reference's mel for ``batch`` (float32 unless ``acoustic_q``)
    and its waveform on ``mel_prog`` (as the tier pads it), in blocks of
    ``block`` utterances on the run's device, TF32 off."""
    ref_ac = _mod(state, 'reference/acoustic')
    ref_gen = _mod(state, 'reference/generator')
    dev = state['ctx']['device']
    acfg = dict(phoneme_encoder=state['hp'].phoneme_encoder,
                frame_decoder=state['hp'].frame_decoder)
    model = ref_ac.Acoustic(state['acoustic_sd'], acfg, q=acoustic_q)
    frames = batch['durations_int'].sum(axis=1)
    T = int(frames.max())
    pad = 0 if state['tier'] == 'float32' else 128
    mels, wavs = [], []
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for s in range(0, len(frames), block):
                sl = slice(s, s + block)

                def t(key, dtype):
                    return torch.as_tensor(batch[key][sl], dtype=dtype,
                                           device=dev)
                mels.append(model.infer(
                    t('symbols', torch.long), t('duration_preds',
                                                torch.float32),
                    t('durations_int', torch.long),
                    t('energy_preds', torch.float32),
                    t('pitch_preds', torch.float32),
                    t('input_lengths', torch.long),
                    torch.as_tensor(frames[sl], device=dev), T,
                    t('spk_embs', torch.float32),
                    t('accent_emb', torch.float32)).cpu())
                m = torch.as_tensor(mel_prog[sl], dtype=torch.float32,
                                    device=dev)
                wavs.append(ref_gen.serve(state['voc_params'], m,
                                          state['voc_cfg'], pad,
                                          q=vocoder_q).cpu())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return torch.cat(mels), torch.cat(wavs)


def compare(batch, mel, wav, mel_ref, wav_ref, hop):
    """One checked batch's readings, each utterance over its own frames:
    the mel's squared gap and squared reference, summed over the batch,
    and per utterance the waveform's rel-L2 (``wav_rel``) and its largest
    sample error over the reference waveform's RMS (``wav_peak``: where
    static activation scales saturate, a few samples go far off while the
    rel-L2 barely moves)."""
    frames = batch['durations_int'].sum(axis=1)
    mel, wav = torch.as_tensor(mel), torch.as_tensor(wav)
    out = dict(mel_gap2=0.0, mel_ref2=0.0, wav_rel=[], wav_peak=[])
    for i, f in enumerate(frames):
        m, r = mel[i, :, :f].double(), mel_ref[i, :, :f].double()
        out['mel_gap2'] += float((m - r).pow(2).sum())
        out['mel_ref2'] += float(r.pow(2).sum())
        w, r = wav[i, :f * hop].double(), wav_ref[i, :f * hop].double()
        out['wav_rel'].append(_rel(w, r))
        out['wav_peak'].append(float((w - r).abs().max() /
                                     (r.pow(2).mean().sqrt() + 1e-30)))
    return out


def numbers(readings):
    """The numbers a synthesis cell can compare, over every checked
    utterance: ``mel_rel``, the rel-L2 of all their mels together (the
    worst utterance's reads up to 4.5 times the 99th percentile, swings
    from seed to seed and comes within three times of the fp8 control's;
    the pooled gap is steady, and half a batch still reads ~1);
    ``wav_rel`` and ``wav_peak``, the worst utterance's. NaN where a
    reading is not finite or there is none."""
    if not readings:
        return dict(mel_rel=float('nan'), wav_rel=float('nan'),
                    wav_peak=float('nan'))
    gap2 = sum(r['mel_gap2'] for r in readings)
    ref2 = sum(r['mel_ref2'] for r in readings)
    out = dict(mel_rel=(gap2 / ref2) ** 0.5 if ref2 > 0 else float('nan'))
    for n in ('wav_rel', 'wav_peak'):
        v = [x for r in readings for x in r[n]]
        out[n] = float(max(v)) if all(np.isfinite(v)) else float('nan')
    return {n: v if np.isfinite(v) else float('nan') for n, v in out.items()}


def check(state):
    lim = state['ctx']['config']['limits']
    hop = state['hp'].hop_length
    readings = []
    for _, batch, mel, wav in state['kept']:
        mel_ref, wav_ref = reference_outputs(state, batch, mel)
        readings.append(compare(batch, mel, wav, mel_ref, wav_ref, hop))
    got = numbers(readings)
    return [(n, got[n], lim[n]) for n in lim]


def control(state):
    """The control's readings on the window's checked batches: the
    reference put in the program's place one precision below the
    configuration's (``config['control']``: the acoustic model in 'fp8',
    the generator in 'int4', or 'program:<tier>', the program's own
    lower tier on the program's mel), judged by the same numbers against
    the float32 reference. Run before :func:`release` (a program tier
    needs the program)."""
    quant = _mod(state, 'reference/quant')
    ctrl = state['ctx']['config']['control']
    hop = state['hp'].hop_length
    prog = None
    if ctrl['vocoder'].startswith('program:'):
        from daft_exprt_torch.models.hifigan import HiFiGanVocoder
        tier = ctrl['vocoder'].split(':', 1)[1]
        cal = state['cal_mels']
        if tier == 'int8-static' and cal is None:
            mix, seed, dims = (state['ctx']['traffic'], state['ctx']['seed'],
                               state['dims'])
            batch = state['ctx']['generator'].Utterances(
                mix, seed, *dims, stream=1).batch()
            cal = state['synth'].infer(**batch)[0][
                :state['ctx']['config']['serve']['calibration_utterances']]
        prog = HiFiGanVocoder(
            state['voc_params'], config=state['voc_cfg'], fast='int8',
            device=state['ctx']['device'],
            int8_calibration_mels=cal if tier == 'int8-static' else None)
    readings = []
    for _, batch, mel, _ in state['kept']:
        mel_ref, _ = reference_outputs(state, batch, mel)
        mel_c, _ = reference_outputs(state, batch, mel,
                                     acoustic_q=quant.CONTROLS[ctrl['acoustic']])
        _, wav_ref = reference_outputs(state, batch, mel_c.numpy())
        if prog is not None:
            wav_c = torch.as_tensor(prog.infer(mel_c.numpy()))
        else:
            _, wav_c = reference_outputs(
                state, batch, mel_c.numpy(),
                vocoder_q=quant.CONTROLS[ctrl['vocoder']])
        readings.append(compare(batch, mel_c, wav_c, mel_ref, wav_ref, hop))
    return list(numbers(readings).items())


def _mod(state, name):
    """The benchmark's helper ``portbench/<name>.py``."""
    return state['ctx']['module'](name)
