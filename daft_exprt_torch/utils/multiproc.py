"""Host-side multiprocessing pool with centralised logging (copy of
``daft_exprt_tpu/utils/multiproc.py``).

Runs ``func`` over an iterable with n_jobs workers, streams the workers'
log records to the parent's loggers and returns the results in input
order. Workers receive a ``log_queue`` keyword.

The workers are forked from the calling process, which may hold a CUDA
context (the port's entry points run on the card). That is safe only
because the functions given here run host Python (text, TextGrids, file
layouts) and never touch torch's CUDA state: a forked child that did would
fail or hang. Do not hand this pool a function that uses the card.
"""
import logging
import logging.handlers
import multiprocessing as mp
import os
import threading
import time

_logger = logging.getLogger(__name__)


def get_nb_jobs(n_jobs):
    """'max' -> all cores, else min(requested, cores)."""
    n_cpus = os.cpu_count() or 1
    if isinstance(n_jobs, str):
        if n_jobs.lower() == 'max':
            return n_cpus
        n_jobs = int(n_jobs)
    return max(1, min(n_jobs, n_cpus))


def _logger_thread(queue):
    while True:
        record = queue.get()
        if record is None:
            break
        logging.getLogger(record.name).handle(record)


def _worker(args):
    func, item, kwargs = args
    return func(item, **kwargs)


class _DirectQueue:
    """In-process stand-in for the log queue (n_jobs == 1)."""

    def put(self, record):
        if record is not None:
            logging.getLogger(record.name).handle(record)


def launch_multi_process(iterable, func, n_jobs, timer_verbose=True,
                         **kwargs):
    """Apply ``func(item, **kwargs, log_queue=q)`` over ``iterable``.

    Results come back in input order. With n_jobs == 1 everything runs in
    process (easier debugging, no fork overhead for small jobs).
    """
    items = list(iterable)
    n_jobs = get_nb_jobs(n_jobs)
    start = time.time()

    if n_jobs == 1 or len(items) <= 1:
        direct = _DirectQueue()
        results = [func(item, **kwargs, log_queue=direct) for item in items]
    else:
        manager = mp.Manager()
        queue = manager.Queue()
        listener = threading.Thread(target=_logger_thread, args=(queue,))
        listener.start()
        try:
            with mp.Pool(n_jobs) as pool:
                results = pool.map(
                    _worker,
                    [(func, item, {**kwargs, 'log_queue': queue})
                     for item in items])
        finally:
            queue.put(None)
            listener.join()
            manager.shutdown()
    if timer_verbose:
        _logger.info(f'{len(items)} items processed in '
                     f'{time.time() - start:.1f}s with {n_jobs} job(s)')
    return results
