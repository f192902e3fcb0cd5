"""Standalone ECAPA speaker-embedding precompute (the port's
``scripts/precompute_ECAPA_spk_embeddings.py``).

    python -m daft_exprt_torch.scripts.precompute_ECAPA_spk_embeddings \
        -tf train.txt [-vf validation.txt] [-dd DATASET] [--overwrite]

Iterates the train/validation file lists, finds each source wav and writes
``<file>.spk_emb.npy`` next to the features, through
``frontend.ecapa.compute_ecapa_for_file_lists`` (SpeechBrain's
ECAPA-TDNN, which must be installed with its weights). ``--device`` is the
encoder's device; its default is cuda here, where the JAX script's is cpu.
"""
import argparse

from daft_exprt_torch.scripts._cli import add_device_flag, parse_args


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-tf', '--training_files', type=str, required=True)
    parser.add_argument('-vf', '--validation_files', type=str, default='')
    parser.add_argument('-dd', '--data_set_dir', type=str, default=None,
                        help='dataset root for wav lookup')
    add_device_flag(parser)
    parser.add_argument('--overwrite', action='store_true')
    return parser


def main(argv=None, embed_fn=None):
    """Compute the embeddings; returns their count. ``embed_fn`` (a 16 kHz
    wav -> embedding callable) replaces the SpeechBrain encoder."""
    from daft_exprt_torch.frontend.ecapa import compute_ecapa_for_file_lists

    args = parse_args(build_parser(), argv)
    lists = [args.training_files]
    if args.validation_files:
        lists.append(args.validation_files)
    n = compute_ecapa_for_file_lists(lists, dataset_dir=args.data_set_dir,
                                     embed_fn=embed_fn, device=args.device,
                                     overwrite=args.overwrite)
    print(f'{n} embeddings computed')
    return n


if __name__ == '__main__':
    main()
