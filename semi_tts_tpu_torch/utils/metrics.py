"""Phonological attribute table reader (counterpart of
`semi_tts_tpu/utils/metrics.py` `read_phn_attr`), using the `csv` module."""

from __future__ import annotations

import csv

import numpy as np

PRESERVE_INDICES = 3  # ['<pad>', '<space>', '<eos>']
SEP = "\t"


def read_phn_attr(phn_attr_pth, neg_val=0):
    """(vocab_size, attr_dim) float32 array: 3 zero rows for the specials,
    then the binary phonological attributes of each phoneme, in file order.
    The file is tab-separated with a header row and the phoneme in the
    first column."""
    with open(phn_attr_pth, newline="") as f:
        rows = list(csv.reader(f, delimiter=SEP))
    attr = np.asarray([[float(v) for v in row[1:]] for row in rows[1:] if row],
                      dtype=np.float32)
    attr[attr == 0] = neg_val
    return np.concatenate([np.zeros((PRESERVE_INDICES, attr.shape[1]), np.float32), attr])
