"""Phoneme text codec (counterpart of `semi_tts_tpu/data/text.py`), with
the file-id map table read by the `csv` module.

Vocabulary: ``["<pad>", "<space>", "<eos>"] + file lines``; ``encode``
strips trailing whitespace, splits on spaces, maps '' to ``<space>`` and
appends a trailing ``<pad>``.
"""

from __future__ import annotations

import csv
from os.path import basename

SEP = "\t"


class PhoneTextEncoder:
    PAD_IDX = 0
    SPACE_IDX = 1
    EOS_IDX = 2

    def __init__(self, vocab_list):
        self._vocab_list = ["<pad>", "<space>", "<eos>"] + list(vocab_list)
        self._vocab2idx = {v: i for i, v in enumerate(self._vocab_list)}
        self.map_table = None

    @property
    def pad_idx(self):
        return self.PAD_IDX

    @property
    def space_idx(self):
        return self.SPACE_IDX

    @property
    def eos_idx(self):
        return self.EOS_IDX

    @property
    def vocab_size(self):
        return len(self._vocab_list)

    @property
    def token_type(self):
        return "phoneme"

    def vocab_to_idx(self, vocab):
        return self._vocab2idx[vocab]

    def idx_to_vocab(self, idx):
        return self._vocab_list[idx]

    def encode(self, s: str):
        s = s.strip("\r\n ").split(" ")
        return [self.vocab_to_idx(v) if v != "" else self.SPACE_IDX for v in s] + [self.PAD_IDX]

    def decode(self, ids):
        return " ".join(self.idx_to_vocab(int(i)) for i in ids)

    @classmethod
    def load_from_file(cls, vocab_file):
        with open(vocab_file, "r") as f:
            vocab_list = [line.strip("\r\n") for line in f]
        return cls(vocab_list)

    def set_map_table(self, table_path):
        """Tab-separated table: a header naming the columns (``phn_seq``,
        ``spkr``, ...) after the file-id column."""
        try:
            with open(table_path, newline="") as f:
                rows = list(csv.reader(f, delimiter=SEP))
        except FileNotFoundError:
            raise FileNotFoundError(
                f"phoneme map table not found: {table_path}. It is a generated "
                "artifact (file-id -> phoneme sequence); see data/README.md.")
        header = rows[0][1:]
        self.map_table = {row[0]: dict(zip(header, row[1:])) for row in rows[1:] if row}

    def file_to_seq(self, file_path):
        file_id = basename(str(file_path)).split(".")[0]
        return self.encode(self.map_table[file_id]["phn_seq"])

    def file_to_spkr(self, file_path):
        file_id = basename(str(file_path)).split(".")[0]
        return self.map_table[file_id]["spkr"]

    def __repr__(self):
        return f"<{type(self).__name__} vocab_size={self.vocab_size}>"


def load_text_encoder(mode, vocab_file, map_table=None):
    if mode != "phoneme":
        raise NotImplementedError(f"`{mode}` is not yet supported.")
    enc = PhoneTextEncoder.load_from_file(vocab_file)
    if map_table is not None:
        enc.set_map_table(map_table)
    return enc
