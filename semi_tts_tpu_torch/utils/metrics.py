"""Phonological attribute table reader and the phone error rate
(counterpart of `semi_tts_tpu/utils/metrics.py` `read_phn_attr`, `cal_per`
and its edit distance); the table is read with the `csv` module."""

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


IGNORE_INDICES = (0, 1, 2, 42)  # pad, space, eos and the last token: not scored


def edit_distance(a, b) -> int:
    """Levenshtein distance of two sequences (numpy dynamic programme)."""
    a, b = list(a), list(b)
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (np.asarray(b) != ca)
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        for j in range(1, len(b) + 1):  # carry insertions left to right
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[-1])


def cal_per(pred, truth, ignore=IGNORE_INDICES, pred_lens=None) -> float:
    """Phone error rate of a batch. ``pred``: (B, T) ids or (B, T, V)
    probabilities; repeats are merged and ``ignore`` ids dropped.
    ``pred_lens``: per-row prediction lengths; frames past them are padding
    and are not scored."""
    if pred is None:
        return float("nan")
    pred = np.asarray(pred)
    truth = np.asarray(truth)
    if pred.ndim >= 3:
        pred = pred.argmax(-1)
    ers = []
    for bi, (p, t) in enumerate(zip(pred, truth)):
        if pred_lens is not None:
            p = p[: int(pred_lens[bi])]
        p = p.tolist()
        p = [v for i, v in enumerate(p) if (i == 0 or v != p[i - 1]) and v not in ignore]
        t = [v for v in t.tolist() if v not in ignore]
        ers.append(edit_distance(p, t) / len(t))
    return sum(ers) / len(ers)
