"""Plot helpers (copy of ``daft_exprt_tpu/utils/plots.py``).
matplotlib is imported when a figure is made, not with the module: the
synthesis path runs without it unless it saves its outputs."""
import numpy as np


def plot_2d_data(data, x_labels=None, filename=None, dpi=100):
    """Stack 2-D arrays (e.g. mel-spec + alignment) into one figure."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    data = [np.asarray(d) for d in data]
    x_labels = x_labels or ['' for _ in data]
    fig, axes = plt.subplots(len(data), 1,
                             figsize=(12, 4 * len(data)), squeeze=False)
    for ax, arr, label in zip(axes[:, 0], data, x_labels):
        im = ax.imshow(arr, aspect='auto', origin='lower', interpolation='none')
        ax.set_title(label)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    if filename is not None:
        fig.savefig(filename, dpi=dpi)
    plt.close(fig)


def plot_1d_overlay(curves, labels=None, filename=None, title='', dpi=100):
    """Overlay 1-D curves (e.g. GT vs predicted pitch)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    labels = labels or ['' for _ in curves]
    for curve, label in zip(curves, labels):
        ax.plot(np.asarray(curve), label=label)
    if any(labels):
        ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    if filename is not None:
        fig.savefig(filename, dpi=dpi)
    plt.close(fig)
