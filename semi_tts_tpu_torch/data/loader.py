"""Bucketed raw-waveform batch loader (counterpart of
`semi_tts_tpu/data/loader.py`).

The host only decodes WAV bytes and pads: the featurizer runs on the
device inside the train step. Waveform lengths are padded up to a small
bucket grid and text lengths to a quantum, so a step sees few shapes. A
background thread prefetches the next batches so host decoding overlaps
the device. Batches stay numpy arrays on the host; the solver moves them
to its device. A batch is decoded by the native decoder's thread pool
(`semi_tts_tpu_torch.native`); a file in a format it does not read goes
through `wavio`.
"""

from __future__ import annotations

import queue
import threading
from os.path import basename

import numpy as np

from .. import native
from . import wavio

SPEC_PAD_VALUE = 0.0

# Wave-length bucket grid (seconds at 22.05 kHz): a batch pads to the
# smallest bucket at or above its longest wave.
DEFAULT_BUCKETS_SEC = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.5, 8.0, 10.0, 12.5, 16.0)
TEXT_QUANTUM = 16


class Batch(dict):
    __getattr__ = dict.__getitem__


def _round_up(n, q):
    return ((n + q - 1) // q) * q


class TTSLoader:
    """Iterates Batches of host-decoded waveforms and encoded text.

    Fields: waves (B, S_bucket) float32, wave_len (B,), sid (B,), text (B,
    U) int32, text_len (B,), fids (list of file ids); each batch sorted by
    length, descending. Items come in a seeded shuffle (a
    ``np.random.RandomState(seed)`` reshuffled each epoch) when ``shuffle``
    is set; with ``drop_last`` a short last batch is dropped."""

    def __init__(self, dataset, tokenizer, *, batch_size=None, shuffle=True,
                 drop_last=True, seed=0, sample_rate=22050,
                 buckets_sec=DEFAULT_BUCKETS_SEC, prefetch=2):
        self.ds = dataset
        self.tok = tokenizer
        self.batch_size = batch_size or dataset.bs_for_collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.sr = sample_rate
        self.bucket_samples = sorted(int(b * sample_rate) for b in buckets_sec)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.ds)
        if self.ds.bucketing:
            return n  # each index yields a bucket
        return n // self.batch_size if self.drop_last else _round_up(n, self.batch_size) // self.batch_size

    def _item_batches(self):
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        if self.ds.bucketing:
            for i in order:
                yield self.ds[int(i)]  # already a list of (path, sid)
        else:
            bs = self.batch_size
            stop = n - bs + 1 if self.drop_last else n
            for s in range(0, max(stop, 1), bs):
                idxs = order[s: s + bs]
                if len(idxs) == 0 or (self.drop_last and len(idxs) < bs):
                    return
                yield [self.ds[int(i)] for i in idxs]

    def _bucket_len(self, n):
        for b in self.bucket_samples:
            if n <= b:
                return b
        return _round_up(n, self.bucket_samples[-1])

    def _check_sr(self, path, sr):
        if sr != self.sr:
            raise ValueError(f"{path}: sample rate {sr}, expected {self.sr}")

    def _decode_batch(self, fpaths):
        """Channel 0 of each file, decoded by the native pool into rows of
        the largest bucket's length; a row it could not decode (length -1)
        is read with `wavio`."""
        arr, lengths, srs = native.wav_read_batch(list(fpaths), self.bucket_samples[-1],
                                                  channel=0, n_threads=4)
        waves = []
        for i, f in enumerate(fpaths):
            if lengths[i] < 0:
                w, sr = wavio.read(f)
                self._check_sr(f, sr)
                waves.append(w[0])
            else:
                self._check_sr(f, srs[i])
                waves.append(arr[i, : lengths[i]])
        return waves

    def _collate(self, items):
        fpaths, sids = zip(*items)
        waves = self._decode_batch(fpaths)
        lens = [len(w) for w in waves]
        order = np.argsort(-np.asarray(lens), kind="stable")  # by length, descending
        waves = [waves[i] for i in order]
        lens = [lens[i] for i in order]
        fpaths = [fpaths[i] for i in order]
        sids = [sids[i] for i in order]

        wave_arr = np.zeros((len(waves), self._bucket_len(max(lens))), np.float32)
        for i, w in enumerate(waves):
            wave_arr[i, : len(w)] = w

        texts = [self.tok.file_to_seq(f) for f in fpaths]
        text_arr = np.zeros((len(texts), _round_up(max(len(t) for t in texts), TEXT_QUANTUM)),
                            np.int32)
        for i, t in enumerate(texts):
            text_arr[i, : len(t)] = t

        return Batch(
            waves=wave_arr,
            wave_len=np.asarray(lens, np.int32),
            sid=np.asarray(sids, np.int32),
            text=text_arr,
            text_len=np.asarray([len(t) for t in texts], np.int32),
            fids=[basename(str(f)).split(".")[0] for f in fpaths],
        )

    def __iter__(self):
        gen = (self._collate(items) for items in self._item_batches())
        if self.prefetch <= 0:
            yield from gen
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()
        err = []

        def worker():
            try:
                for b in gen:
                    q.put(b)
            except Exception as e:  # raised to the consumer below
                err.append(e)
            finally:
                q.put(end)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            b = q.get()
            if b is end:
                if err:
                    raise err[0]
                return
            yield b


def infinite(loader):
    """Endless epochs of ``loader``; raises instead of spinning when an
    epoch yields no batch (a split smaller than its batch with
    ``drop_last``)."""
    while True:
        n = 0
        for b in loader:
            n += 1
            yield b
        if n == 0:
            raise RuntimeError(
                "infinite(loader): the loader yielded no batches: a split smaller than "
                "batch_size with drop_last=True? Lower the batch size for this split.")
