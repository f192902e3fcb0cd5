"""Run a function on every rank of a new process group, one spawned process
a rank, on one host.

``run_ranks(fn, world_size, args)`` starts ``world_size`` processes (the
'spawn' start method, so CUDA works in them), each of which joins a process
group through a ``file://`` store of its own (no port to race for), calls
``fn(rank, *args)`` and hands back its result. Every process is joined
under one deadline: a rank that fails stops the others at once, a rank that
hangs is killed at the deadline, and either raises in the caller. ``fn`` and
its arguments and result must pickle (a module-level function; arrays on
the host).
"""
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback


def _child(rank, world_size, init_method, backend, device, pg_timeout,
           threads, call_path, out_path):
    import torch
    import torch.distributed as dist

    from daft_exprt_torch.parallel.mesh import init_distributed
    code = 0
    try:
        with open(call_path, 'rb') as f:
            fn, args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        init_distributed(rank, world_size, init_method, backend=backend,
                         timeout=pg_timeout, device=device)
        payload = ('ok', fn(rank, *args))
    except Exception:                # reported to the caller, which raises
        payload, code = ('error', traceback.format_exc()), 1
    with open(out_path, 'wb') as f:
        pickle.dump(payload, f)
    if code == 0 and dist.is_initialized():
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)                   # no atexit hooks of a broken group


def run_ranks(fn, world_size, args=(), backend=None, device=None,
              timeout=600.0, pg_timeout=60.0, threads=None):
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each in its own
    process on a process group of ``world_size`` ranks.

    ``device``/``backend``: as :func:`mesh.init_distributed` (default cuda
    and nccl; the CPU tests pass ``device='cpu'``). ``timeout``: seconds for
    the whole run; ``pg_timeout``: the group's collective timeout;
    ``threads``: torch's intra-op threads in each process. Raises
    ``RuntimeError`` with every failed rank's traceback, ``TimeoutError``
    if a rank is still running at the deadline."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    work = tempfile.mkdtemp(prefix='ranks-')
    init_method = 'file://' + os.path.join(work, 'store')
    outs = [os.path.join(work, f'rank{r}.pkl') for r in range(world_size)]
    # the call goes through a file: a spawned process reads its pipe only
    # after importing the caller's main module, so arguments larger than
    # the pipe's buffer would start the ranks one after another
    call_path = os.path.join(work, 'call.pkl')
    with open(call_path, 'wb') as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_child, args=(
        r, world_size, init_method, backend, device, pg_timeout, threads,
        call_path, outs[r])) for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break                        # a rank failed: stop the rest
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f'ranks {[r for r, p in enumerate(procs) if p.is_alive()]}'
                    f' of {world_size} still running after {timeout} s')
            time.sleep(0.02)
        errors, results = [], []
        time.sleep(0.2)              # let a failing rank's peers report
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.is_alive():
                p.kill()
            p.join()
            if os.path.isfile(out):
                with open(out, 'rb') as f:
                    status, value = pickle.load(f)
            else:
                status, value = 'error', f'exit code {p.exitcode}, no result'
            if status == 'ok':
                results.append(value)
            else:
                errors.append(f'--- rank {r}:\n{value}')
        if errors:
            raise RuntimeError('ranks failed:\n' + '\n'.join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
