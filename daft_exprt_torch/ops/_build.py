"""Build the CUDA kernels of ``ops/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface,
``build/lib<name>-<digest>.so`` at the repo root, and loaded with
``ctypes``. The digest covers the source, the shared headers and the
flags, so an edited source builds anew and an unchanged one is reused.
``build()`` starts one ``nvcc`` per source, all at once.

The C entry points take pointers and the CUDA stream as ``void*`` and
return ``cudaGetLastError()`` after their launches; :func:`check` turns a
non-zero return into an exception.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
SOURCES = ('attention_fwd', 'attention_bwd', 'mrf_tc', 'mrf_phase',
           'mrf_tc_q8', 'mrf_ptc', 'mrf_ct_q8', 'mrf_phase_q8', 'mrf_ct')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_libs = {}


def nvcc_path():
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    cands = [os.path.join(home, 'bin', 'nvcc')] if home else []
    which = shutil.which('nvcc')
    if which:
        cands.append(which)
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       'to build the port\'s CUDA kernels')


def library_path(name):
    """build/lib<name>-<digest>.so, the digest over the source, the shared
    headers and the flags."""
    h = hashlib.sha256()
    for f in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(names=SOURCES):
    """Compile the named sources that have no up-to-date library, one
    ``nvcc`` each, all started together. Returns {name: seconds} for the
    ones it compiled. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f'--- nvcc {name}.cu (exit {proc.returncode})\n{log}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return seconds


def library(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')


def stream_ptr(tensor):
    """The current CUDA stream of ``tensor``'s device, as a ``void*``."""
    import torch
    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())
