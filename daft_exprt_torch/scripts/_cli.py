"""What every tool of ``daft_exprt_torch.scripts`` shares: the repo root,
the ``--device`` flag and argument parsing that resolves it first."""
import logging
import os

from daft_exprt_torch.device import resolve_device

PROJECT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))
LOG_FORMAT = '%(asctime)s [%(levelname)s] %(message)s'


def add_device_flag(parser):
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu: cpu runs the plain '
                             'PyTorch versions of the kernels')


def parse_args(parser, argv=None):
    """``parser.parse_args(argv)`` with ``args.device`` resolved (raises
    without CUDA unless it is 'cpu'), before the tool touches any file;
    then logging at INFO."""
    args = parser.parse_args(argv)
    args.device = str(resolve_device(args.device))
    logging.basicConfig(format=LOG_FORMAT, datefmt='%Y-%m-%d %H:%M:%S',
                        level=logging.INFO)
    return args
