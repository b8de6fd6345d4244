"""Corpus datasets driven by CSV partition tables and speaker maps
(counterpart of `semi_tts_tpu/data/corpus.py`), the tables read with the
`csv` module.

A split's rows: ``path/speaker/id.wav`` file paths (LJSpeech: ``path/wavs/
id.wav``) and speaker ids through a JSON map, sorted by duration,
descending, in the order the JAX package's table sort gives; the test
split drops the 'lj' speaker. With bucketing (train splits only) an item
is a batch of ``batch_size`` rows of similar duration.
"""

from __future__ import annotations

import csv
import json
from os.path import join

import numpy as np


def _descending(durations):
    """The row order of a descending quicksort of ``durations``, as a
    pandas ``sort_values(ascending=False)`` gives it (ties included)."""
    d = np.asarray(durations, np.float64)
    idx = np.arange(len(d))[::-1]
    return idx[d[::-1].argsort(kind="quicksort")][::-1]


def read_partition(partition_table, split):
    """The rows of ``split``: dicts of the file id (the first column) and
    the named columns, in file order; ``duration`` as a float."""
    with open(partition_table, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    out = []
    for row in rows[1:]:
        if not row:
            continue
        rec = dict(zip(header[1:], row[1:]), fid=row[0])
        if rec["split"] == split:
            rec["duration"] = float(rec["duration"])
            out.append(rec)
    return out


class VCTKDataset:
    """Rows: (file_path, speaker_id)."""

    def __init__(self, path, partition_table, split, bucketing, batch_size, spkr_map):
        self.path = path
        self.split = split
        self.batch_size = batch_size
        self.bucketing = bucketing and (split not in ["dev", "test"])
        self.bs_for_collate = 1 if self.bucketing else batch_size
        with open(spkr_map) as f:
            self.spkr_map = json.load(f)
        rows = read_partition(partition_table, split)
        if not rows:
            # an empty split keeps one placeholder row, as the JAX table does
            self.rows = [dict(fid=None, file_path=None, speaker=0, duration=0.0)]
        else:
            rows = [rows[i] for i in _descending([r["duration"] for r in rows])]
            for r in rows:
                r["file_path"] = self._file_path(r)
                r["speaker"] = self.spkr_map[r["speaker"]]
            if split == "test" and "lj" in self.spkr_map:
                rows = [r for r in rows if r["speaker"] != self.spkr_map["lj"]]
            self.rows = rows
        self.n_spkr = len(self.spkr_map)

    def _file_path(self, row):
        return join(self.path, row["speaker"], row["fid"] + ".wav")

    def get_statics(self):
        return "           | {} size = {}\t| Duration = {:.1f}\t| Bucketing = {} ".format(
            self.split.replace("unpaired", "unpair"), len(self.rows),
            sum(r["duration"] for r in self.rows) / 60, self.bucketing)

    def __getitem__(self, index):
        if self.bucketing:
            index = min(len(self.rows) - self.batch_size, index)
            return [(r["file_path"], r["speaker"])
                    for r in self.rows[index: index + self.batch_size]]
        row = self.rows[index]
        return row["file_path"], row["speaker"]

    def __len__(self):
        return len(self.rows)


class LJSpeechDataset(VCTKDataset):
    """LJSpeech layout: the wavs lie flat under ``path/wavs``."""

    def _file_path(self, row):
        return join(self.path, "wavs", row["fid"] + ".wav")


def create_dataset(name, path, bucketing, batch_size, spkr_map, partition_table,
                   inference_stage, **kwargs):
    """The four splits: (unpaired, paired, dev, test or None, messages)."""
    if name.lower() == "vctk":
        Dataset = VCTKDataset
    elif name.lower() == "ljspeech":
        Dataset = LJSpeechDataset
    else:
        raise NotImplementedError(name)

    msg = [f"Data spec. | Corpus = {name} (from {path})\t| Batch size = {batch_size}"]
    pair_set = Dataset(path, partition_table, "paired", bucketing, batch_size, spkr_map)
    unpair_set = Dataset(path, partition_table, "unpaired", bucketing, batch_size, spkr_map)
    dev_set = Dataset(path, partition_table, "dev", bucketing, batch_size, spkr_map)
    test_set = None
    if inference_stage:
        test_set = Dataset(path, partition_table, "test", bucketing, batch_size, spkr_map)
        msg.append(test_set.get_statics())
    else:
        msg.extend([pair_set.get_statics(), unpair_set.get_statics(), dev_set.get_statics()])
    return unpair_set, pair_set, dev_set, test_set, msg
