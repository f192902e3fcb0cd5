"""Dataset + collation (numpy host pipeline feeding device batches).

The port's own copy of ``daft_exprt_tpu/data/dataset.py`` (numpy only):
the same files and seed give the same batches.

Consumes the same on-disk feature layout as the reference
(reference: src/daft_exprt/data_loader.py:14-198): per-utterance ``.npy``
mel, ``.markers`` (begin/end/int_dur/symbol/word/word_idx), ``.frames_nrg``/
``.symbols_nrg``/``.frames_f0``/``.symbols_f0`` text tracks, and
``.spk_emb.npy`` ECAPA embeddings; training-file lists are
``features_dir|file|speaker_id`` lines.

TPU-first collation: batches are padded to configured length/frame buckets
(not the ragged batch max) so every training step hits a warm jit cache; a
``bucket=False`` mode reproduces the reference's batch-max padding.
Corrupt samples are skipped with neighbor retry like the reference
(data_loader.py:180-195).
"""
import logging
import os
import random

import numpy as np

_logger = logging.getLogger(__name__)


def _read_floats(path):
    with open(path, 'r', encoding='utf-8') as f:
        return np.array([float(line.strip()) for line in f], dtype=np.float32)


class DaftExprtDataset:
    def __init__(self, data_file, hparams, shuffle=True, normalize=False):
        """``normalize=False`` leaves prosody raw for the dynamic stats
        manager (reference return_raw_stats=True path)."""
        if not os.path.isfile(data_file):
            raise FileNotFoundError(data_file)
        with open(data_file, 'r', encoding='utf-8') as f:
            self.data = [line.strip().split('|') for line in f if line.strip()]
        self.hparams = hparams
        self.normalize = normalize
        self.symbol_to_id = {s: i for i, s in enumerate(hparams.symbols)}
        if shuffle:
            rng = random.Random(hparams.seed)
            rng.shuffle(self.data)

    def __len__(self):
        return len(self.data)

    def _load_item(self, index):
        features_dir, feature_file, speaker_id = self.data[index][:3]
        speaker_id = int(speaker_id)
        base = os.path.join(features_dir, feature_file)

        mel = np.load(f'{base}.npy')
        assert mel.shape[0] == self.hparams.n_mel_channels

        symbols, dur_float, dur_int = [], [], []
        with open(f'{base}.markers', 'r', encoding='utf-8') as f:
            for line in f:
                begin, end, int_dur, symbol, _, _ = line.strip().split('\t')
                symbols.append(self.symbol_to_id[symbol])
                dur_float.append(float(end) - float(begin))
                dur_int.append(int(int_dur))
        symbols = np.array(symbols, dtype=np.int64)
        dur_float = np.array(dur_float, dtype=np.float32)
        dur_int = np.array(dur_int, dtype=np.int64)

        symbols_energy = _read_floats(f'{base}.symbols_nrg')
        symbols_pitch = _read_floats(f'{base}.symbols_f0')
        frames_energy = _read_floats(f'{base}.frames_nrg')
        frames_pitch = _read_floats(f'{base}.frames_f0')

        if self.normalize:
            st = self.hparams.stats[f'spk {speaker_id}']
            for arr, key in ((symbols_energy, 'energy'),
                             (frames_energy, 'energy'),
                             (symbols_pitch, 'pitch'),
                             (frames_pitch, 'pitch')):
                nz = arr != 0.0
                arr[nz] = (arr[nz] - st[key]['mean']) / st[key]['std']

        T = mel.shape[1]
        assert dur_int.sum() == T, \
            f'{base}: durations {dur_int.sum()} != mel frames {T}'
        assert len(frames_energy) == T and len(frames_pitch) == T
        assert len(symbols) == len(symbols_energy) == len(symbols_pitch)

        spk_emb_path = f'{base}.spk_emb.npy'
        if not os.path.isfile(spk_emb_path):
            raise FileNotFoundError(
                f'{spk_emb_path}: speaker embeddings are mandatory — run '
                f'pre_process to compute ECAPA embeddings')
        spk_emb = np.load(spk_emb_path).reshape(-1).astype(np.float32)

        return dict(symbols=symbols, durations_float=dur_float,
                    durations_int=dur_int, symbols_energy=symbols_energy,
                    symbols_pitch=symbols_pitch, frames_energy=frames_energy,
                    frames_pitch=frames_pitch, mel_spec=mel.astype(np.float32),
                    speaker_id=speaker_id, features_dir=features_dir,
                    feature_file=feature_file, spk_emb=spk_emb)

    def __getitem__(self, index):
        """Skip-and-retry on corrupt samples (up to 100 neighbors)."""
        last_err = None
        for offset in range(100):
            try:
                return self._load_item((index + offset) % len(self.data))
            except (OSError, EOFError, AssertionError, ValueError,
                    KeyError) as e:
                last_err = e
                if offset == 0:
                    _logger.warning(f'skipping corrupt sample {index}: {e}')
        raise RuntimeError(f'too many corrupt samples near {index}: {last_err}')


def _bucket(value, buckets):
    for b in buckets:
        if value <= b:
            return b
    stride = buckets[-1] - buckets[-2] if len(buckets) > 1 else buckets[-1]
    return buckets[-1] + -(-(value - buckets[-1]) // stride) * stride


def collate_batch(items, hparams, bucket=True):
    """items: list of dataset dicts → padded numpy batch dict, sorted by
    symbol length descending (reference collation order)."""
    order = np.argsort([-len(it['symbols']) for it in items], kind='stable')
    items = [items[i] for i in order]
    B = len(items)
    L_max = max(len(it['symbols']) for it in items)
    T_max = max(it['mel_spec'].shape[1] for it in items)
    if bucket:
        L_max = _bucket(L_max, hparams.length_buckets)
        T_max = _bucket(T_max, hparams.frame_buckets)

    emb_dim = items[0]['spk_emb'].shape[0]
    n_mel = hparams.n_mel_channels
    batch = dict(
        symbols=np.zeros((B, L_max), dtype=np.int64),
        durations_float=np.zeros((B, L_max), dtype=np.float32),
        durations_int=np.zeros((B, L_max), dtype=np.int64),
        symbols_energy=np.zeros((B, L_max), dtype=np.float32),
        symbols_pitch=np.zeros((B, L_max), dtype=np.float32),
        input_lengths=np.zeros((B,), dtype=np.int64),
        frames_energy=np.zeros((B, T_max), dtype=np.float32),
        frames_pitch=np.zeros((B, T_max), dtype=np.float32),
        mel_specs=np.zeros((B, n_mel, T_max), dtype=np.float32),
        output_lengths=np.zeros((B,), dtype=np.int64),
        speaker_ids=np.zeros((B,), dtype=np.int64),
        spk_embs=np.zeros((B, emb_dim), dtype=np.float32),
    )
    feature_dirs, feature_files = [], []
    for i, it in enumerate(items):
        L = len(it['symbols'])
        T = it['mel_spec'].shape[1]
        batch['symbols'][i, :L] = it['symbols']
        batch['durations_float'][i, :L] = it['durations_float']
        batch['durations_int'][i, :L] = it['durations_int']
        batch['symbols_energy'][i, :L] = it['symbols_energy']
        batch['symbols_pitch'][i, :L] = it['symbols_pitch']
        batch['input_lengths'][i] = L
        batch['frames_energy'][i, :T] = it['frames_energy']
        batch['frames_pitch'][i, :T] = it['frames_pitch']
        batch['mel_specs'][i, :, :T] = it['mel_spec']
        batch['output_lengths'][i] = T
        batch['speaker_ids'][i] = it['speaker_id']
        batch['spk_embs'][i] = it['spk_emb']
        feature_dirs.append(it['features_dir'])
        feature_files.append(it['feature_file'])
    return batch, feature_dirs, feature_files


class BatchIterator:
    """Epoch iterator with per-host sharding for multi-host data parallelism.

    Replaces torch DataLoader + DistributedSampler
    (reference: src/daft_exprt/data_loader.py:290-330): each host reads the
    shard ``host_id::num_hosts`` of the epoch permutation; batches are
    bucket-padded for static shapes.
    """

    def __init__(self, dataset, hparams, batch_size, shuffle=True,
                 drop_last=True, host_id=0, num_hosts=1, bucket=True,
                 seed=None):
        self.dataset = dataset
        self.hparams = hparams
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.bucket = bucket
        self.seed = seed if seed is not None else hparams.seed
        self.epoch = 0
        n = len(dataset)
        if drop_last and n > batch_size * num_hosts:
            self.drop_last = True
        else:
            if drop_last:
                _logger.warning(
                    f'dataset ({n}) <= global batch '
                    f'({batch_size * num_hosts}); keeping partial batches')
            self.drop_last = False

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        per_host = len(self.dataset) // self.num_hosts
        if self.drop_last:
            return per_host // self.batch_size
        return -(-per_host // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % (2 ** 31))
            perm = rng.permutation(n)
        else:
            perm = np.arange(n)
        shard = perm[self.host_id::self.num_hosts]
        nb = len(shard) // self.batch_size if self.drop_last \
            else -(-len(shard) // self.batch_size)
        for b in range(nb):
            idxs = shard[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in idxs]
            yield collate_batch(items, self.hparams, bucket=self.bucket)


class PrefetchIterator:
    """Background-thread batch prefetch with a bounded queue — the
    equivalent of the reference's DataLoader ``num_workers``
    (reference: src/daft_exprt/train.py:302): file reads + collation
    overlap the device step instead of sitting on the critical path
    between steps. NumPy IO releases the GIL, so one thread suffices.

    Wraps any re-iterable; ``set_epoch``/``__len__`` pass through.
    """

    def __init__(self, inner, depth=2):
        self.inner = inner
        self.depth = depth

    def set_epoch(self, epoch):
        if hasattr(self.inner, 'set_epoch'):
            self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        import queue
        import threading
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        DONE, ERROR = object(), object()

        def put(item):
            # bounded put that aborts when the consumer went away, so an
            # early `break` out of the epoch (train.py ends mid-epoch on
            # the final iteration) cannot leak a blocked thread + batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.inner:
                    if not put(item):
                        return
                put(DONE)
            except BaseException as exc:              # noqa: BLE001
                put((ERROR, exc))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is ERROR:
                    raise item[1]
                yield item
        finally:
            stop.set()
            while not q.empty():      # unblock a put-in-progress
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


def prepare_data_iterators(hparams, batch_size=None, host_id=0, num_hosts=1,
                           bucket=True, prefetch=2):
    """Train/validation iterators over the configured file lists.
    ``prefetch`` > 0 wraps the train iterator in a background-thread
    prefetcher of that depth (validation stays synchronous)."""
    batch_size = batch_size or hparams.batch_size
    train_set = DaftExprtDataset(hparams.training_files, hparams,
                                 shuffle=True, normalize=False)
    val_set = DaftExprtDataset(hparams.validation_files, hparams,
                               shuffle=False, normalize=False)
    train_it = BatchIterator(train_set, hparams, batch_size, shuffle=True,
                             drop_last=True, host_id=host_id,
                             num_hosts=num_hosts, bucket=bucket)
    if prefetch:
        train_it = PrefetchIterator(train_it, depth=prefetch)
    val_it = BatchIterator(val_set, hparams, batch_size, shuffle=False,
                           drop_last=False, host_id=host_id,
                           num_hosts=num_hosts, bucket=bucket)
    return train_it, val_it, len(train_set)
