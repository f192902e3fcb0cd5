"""Train the PitchPredictor that the pitch-consistency loss reads frozen
(the port's ``scripts/train_pitch_predictor.py``).

    python -m daft_exprt_torch.scripts.train_pitch_predictor -fd FEATURES \
        -out OUT [--epochs 5] [--batch_size 8] [--device cuda]

Every (``<name>.npy`` mel, ``<name>.frames_f0``) pair under the features
directory, padded or cut to ``t_max`` frames; masked MSE on the voiced,
valid frames; Adam; BatchNorm on batch statistics with its running
averages updated (flax's momentum 0.9) and dropout 0.1 from a generator
seeded per step. Each epoch writes ``pitch_predictor_epoch_<n>``, a port
checkpoint whose model state dict ``train.load_frozen_pitch_predictor``
loads strictly (``pitch_predictor_path``).
"""
import argparse
import logging
import os

import numpy as np

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args

_logger = logging.getLogger(__name__)


def collect_files(features_dir):
    """All (mel.npy, frames_f0) pairs under a features directory, as
    sorted base paths."""
    pairs = []
    for root, _, files in os.walk(features_dir):
        for f in files:
            if f.endswith('.npy') and not f.endswith('.spk_emb.npy'):
                base = os.path.join(root, f[:-4])
                if os.path.isfile(base + '.frames_f0'):
                    pairs.append(base)
    return sorted(pairs)


def batches(pairs, batch_size, t_max, rng):
    """One epoch of (mels (B, n_mels, t_max), f0 (B, t_max), lengths (B,))
    in ``rng``'s order, the last partial batch dropped."""
    order = rng.permutation(len(pairs))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        mels, pitches, lengths = [], [], []
        for j in order[i:i + batch_size]:
            mel = np.load(pairs[j] + '.npy')
            with open(pairs[j] + '.frames_f0') as f:
                f0 = np.array([float(x) for x in f], dtype=np.float32)
            T = min(mel.shape[1], len(f0), t_max)
            m = np.full((mel.shape[0], t_max), np.log(1e-5), dtype=np.float32)
            m[:, :T] = mel[:, :T]
            p = np.zeros(t_max, dtype=np.float32)
            p[:T] = f0[:T]
            mels.append(m)
            pitches.append(p)
            lengths.append(T)
        yield (np.stack(mels), np.stack(pitches),
               np.array(lengths, dtype=np.int64))


def masked_mse(pred, f0, lengths):
    """MSE over the frames that are inside their utterance and voiced."""
    import torch

    T = pred.shape[1]
    mask = ((torch.arange(T, device=pred.device)[None, :] < lengths[:, None])
            & (f0 != 0.0)).float()
    return torch.sum(((pred - f0) ** 2) * mask) / (torch.sum(mask) + 1e-5)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-fd', '--features_dir', type=str, required=True)
    parser.add_argument('-out', '--output_dir', type=str, required=True)
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--t_max', type=int, default=1024)
    parser.add_argument('--learning_rate', type=float, default=1e-4)
    parser.add_argument('--n_mel_channels', type=int, default=80)
    parser.add_argument('--seed', type=int, default=1234)
    add_device_flag(parser)
    return parser


def main(argv=None):
    """Train and write a checkpoint an epoch; returns the last one's
    path."""
    import torch

    from daft_exprt_torch import checkpoint as ckpt
    from daft_exprt_torch.models import pitch_predictor as pp_module
    from daft_exprt_torch.parallel.train_step import step_seed

    args = parse_args(build_parser(), argv)
    dev = torch.device(args.device)
    pairs = collect_files(args.features_dir)
    if not pairs:
        raise ValueError(f'no (mel, frames_f0) pairs in {args.features_dir}')
    _logger.info(f'{len(pairs)} training files')

    model = pp_module.PitchPredictor(n_mel_channels=args.n_mel_channels)
    model = model.init_random_(args.seed).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=args.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(dev)

    np_rng = np.random.RandomState(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    step, path = 0, None
    for epoch in range(1, args.epochs + 1):
        losses = []
        for mel, f0, lengths in batches(pairs, args.batch_size, args.t_max,
                                        np_rng):
            mel, f0, lengths = (torch.from_numpy(a).to(dev)
                                for a in (mel, f0, lengths))
            gen.manual_seed(step_seed(args.seed, step, 0))
            loss = masked_mse(model(mel, generator=gen), f0, lengths)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            step += 1
        _logger.info(f'epoch {epoch}: masked MSE {np.mean(losses):.5f} '
                     f'({len(losses)} steps)')
        path = os.path.join(args.output_dir,
                            f'pitch_predictor_epoch_{epoch}')
        ckpt.save_checkpoint(path, model.state_dict(), opt.state_dict(),
                             iteration=step,
                             learning_rate=args.learning_rate)
    _logger.info('done')
    return path


if __name__ == '__main__':
    main()
