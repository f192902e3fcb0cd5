"""Training CLI (the port's ``scripts/training.py``): ``pre_process`` /
``train`` / ``fine_tune``.

    python -m daft_exprt_torch.scripts.training -dd DATASET -en NAME \
        [--device cuda] pre_process [--skip_mfa] [--skip_ecapa]
    python -m daft_exprt_torch.scripts.training -dd DATASET -en NAME train
    python -m daft_exprt_torch.scripts.training -dd DATASET -en NAME fine_tune

Speaker auto-discovery, the preprocessing chain (MFA -> features -> sets
-> stats -> ECAPA), the training launch (one process, or one rank of a
data-parallel run: ``--coordinator_address host:port --num_hosts N
--host_id i`` joins a process group over TCP first) and the vocoder
fine-tuning dataset, with the experiment's config saved and merged under
``<experiments_dir>/<experiment_name>/``.
"""
import argparse
import json
import logging
import os

from daft_exprt_torch.scripts._cli import (
    PROJECT_ROOT, add_device_flag, parse_args,
)

_logger = logging.getLogger(__name__)


def list_all_speakers(data_set_dir):
    """Every sub-directory with a wavs/ + metadata.csv is a speaker."""
    speakers = []
    for entry in sorted(os.listdir(data_set_dir)):
        spk_dir = os.path.join(data_set_dir, entry)
        if (os.path.isdir(os.path.join(spk_dir, 'wavs'))
                and os.path.isfile(os.path.join(spk_dir, 'metadata.csv'))):
            speakers.append(entry)
    return speakers


def build_hparams(args, check_mfa=False):
    from daft_exprt_torch.hparams import HyperParams

    experiment_dir = os.path.join(args.experiments_dir, args.experiment_name)
    speakers = args.speakers or list_all_speakers(args.data_set_dir)
    kwargs = dict(
        training_files=os.path.join(experiment_dir, 'train.txt'),
        validation_files=os.path.join(experiment_dir, 'validation.txt'),
        output_directory=experiment_dir,
        language=args.language,
        speakers=speakers,
    )
    # merge a previously saved experiment config (excluding stats)
    config_file = os.path.join(experiment_dir, 'config.json')
    if os.path.isfile(config_file) and not args.ignore_saved_config:
        with open(config_file) as f:
            saved = json.load(f)
        for key in ('stats', 'training_files', 'validation_files',
                    'output_directory', 'mfa_dictionary', 'mfa_g2p_model',
                    'mfa_acoustic_model', 'n_symbols'):
            saved.pop(key, None)
        saved.update(kwargs)
        kwargs = saved
    if args.config_overrides:
        kwargs.update(json.loads(args.config_overrides))
    return HyperParams(check_mfa=check_mfa, **kwargs)


def pre_process(args):
    """MFA -> features (on ``args.device``) -> sets -> stats -> ECAPA."""
    from daft_exprt_torch.data.sets import (
        create_sets, extract_features_stats, save_stats,
    )
    from daft_exprt_torch.frontend.extract_features import (
        check_features_config_used, extract_features,
    )
    from daft_exprt_torch.frontend.mfa import mfa

    hparams = build_hparams(args, check_mfa=not args.skip_mfa)
    features_dir = args.features_dir or os.path.join(
        args.experiments_dir, 'features')

    if not args.skip_mfa:
        mfa(args.data_set_dir, hparams, n_jobs=args.nb_jobs)
    if not check_features_config_used(features_dir, hparams):
        raise ValueError('feature config mismatch with existing features -- '
                         'use a fresh features_dir or align parameters')
    extract_features(args.data_set_dir, features_dir, hparams,
                     n_jobs=args.nb_jobs, pitch_method=args.pitch_method,
                     device=args.device)
    create_sets(features_dir, hparams,
                proportion_validation=args.proportion_validation)
    stats = extract_features_stats(hparams)
    save_stats(stats, hparams.output_directory)
    if not args.skip_ecapa:
        from daft_exprt_torch.frontend.ecapa import (
            compute_ecapa_for_file_lists,
        )
        compute_ecapa_for_file_lists(
            [hparams.training_files, hparams.validation_files],
            dataset_dir=args.data_set_dir, device=args.device)
    _logger.info('pre-processing complete')


def train(args):
    """``launch_training`` on ``args.device``; with
    ``--coordinator_address``, as rank ``host_id`` of ``num_hosts`` (one
    process per rank, NCCL on the card, gloo on the CPU)."""
    from daft_exprt_torch.train import launch_training

    if args.coordinator_address:
        from daft_exprt_torch.parallel.mesh import init_distributed
        init_distributed(args.host_id, args.num_hosts,
                         f'tcp://{args.coordinator_address}',
                         device=args.device)
    hparams = build_hparams(args)
    if args.checkpoint:
        hparams.checkpoint = args.checkpoint
    return launch_training(hparams, num_iterations=args.num_iterations,
                           device=args.device)


def fine_tune(args):
    from daft_exprt_torch.fine_tune import launch_fine_tuning

    hparams = build_hparams(args)
    if args.checkpoint:
        hparams.checkpoint = args.checkpoint
    return launch_fine_tuning(hparams, args.data_set_dir, device=args.device)


def build_parser():
    parser = argparse.ArgumentParser(
        description='daft_exprt_torch training pipeline')
    parser.add_argument('-dd', '--data_set_dir', type=str, required=True,
                        help='dataset root: <speaker>/{metadata.csv,wavs/}')
    parser.add_argument('-ed', '--experiments_dir', type=str,
                        default=os.path.join(PROJECT_ROOT, 'trainings'))
    parser.add_argument('-en', '--experiment_name', type=str, required=True)
    parser.add_argument('-l', '--language', type=str, default='english')
    parser.add_argument('-spks', '--speakers', nargs='*', default=None,
                        help='speakers to use (default: auto-discover)')
    parser.add_argument('-nj', '--nb_jobs', type=int, default=4)
    parser.add_argument('--config_overrides', type=str, default='',
                        help='JSON dict of hyper-parameter overrides')
    parser.add_argument('--ignore_saved_config', action='store_true')
    add_device_flag(parser)

    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('pre_process')
    p.add_argument('-fd', '--features_dir', type=str, default='')
    p.add_argument('--proportion_validation', type=float, default=0.1)
    p.add_argument('--skip_mfa', action='store_true',
                   help='skip MFA (alignments already in <speaker>/align)')
    p.add_argument('--skip_ecapa', action='store_true',
                   help='skip ECAPA embedding precompute')
    p.add_argument('--pitch_method', type=str, default='auto',
                   choices=['auto', 'native', 'device'])
    p.set_defaults(func=pre_process)

    p = sub.add_parser('train')
    p.add_argument('-chk', '--checkpoint', type=str, default='')
    p.add_argument('--num_iterations', type=int, default=None)
    p.add_argument('--coordinator_address', type=str, default='',
                   help='host:port of rank 0 for data-parallel training')
    p.add_argument('--num_hosts', type=int, default=1)
    p.add_argument('--host_id', type=int, default=0)
    p.set_defaults(func=train)

    p = sub.add_parser('fine_tune')
    p.add_argument('-chk', '--checkpoint', type=str, default='')
    p.set_defaults(func=fine_tune)
    return parser


def main(argv=None):
    """Run the chosen command; returns what it returns (train: the model
    and its final metrics; fine_tune: the dataset's root)."""
    args = parse_args(build_parser(), argv)
    return args.func(args)


if __name__ == '__main__':
    main()
