"""Small host-side helpers (copy of ``daft_exprt_tpu/utils/misc.py``)."""
import sys
import time


def chunker(seq, size):
    """Split a sequence into chunks of at most ``size`` items."""
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))


def estimate_required_time(nb_items_in_list, current_index, time_elapsed,
                           interval=100):
    """Print a crude ETA every ``interval`` items (single line, stdout)."""
    if current_index % interval == 0 and current_index > 0:
        time_per_item = time_elapsed / current_index
        remaining = time_per_item * (nb_items_in_list - current_index)
        sys.stdout.write(
            f'\r{current_index}/{nb_items_in_list} items -- '
            f'~{remaining:.0f}s remaining')
        sys.stdout.flush()


class Timer:
    """Context-manager wall timer for profiling sections."""

    def __init__(self, name=''):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        return False
