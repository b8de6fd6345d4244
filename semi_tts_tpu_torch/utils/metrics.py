"""Phonological attribute table reader, the phone error rate, the codebook
perplexity and the mel-cepstral distortion (counterpart of
`semi_tts_tpu/utils/metrics.py` `read_phn_attr`, `cal_per` and its edit
distance, which runs in the port's native code, `cal_ppx` and `mcd`); the
table is read with the `csv` module, the rest is numpy."""

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
    """Levenshtein distance of two token sequences (the native
    `stt_edit_distance`)."""
    from .. import native

    return native.edit_distance(list(a), list(b))


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


def human_format(num):
    """``num`` with a K/M/G/T/P suffix, as the progress lines print steps."""
    magnitude = 0
    while num >= 1000:
        magnitude += 1
        num /= 1000.0
    return "{:3}{}".format(num, [" ", "K", "M", "G", "T", "P"][magnitude])


def cal_ppx(prob) -> float:
    """Codebook perplexity ``2^H`` of (B, T, V) posteriors, the entropy
    averaged over each row's frames that are not all zero, then over rows."""
    prob = np.asarray(prob)
    prob_len = np.sum(prob.sum(-1) != 0, axis=-1, keepdims=True).astype(np.float64)
    entropy = -np.sum(prob * np.log2(prob + 1e-10), axis=-1)
    entropy = np.mean(entropy.sum(-1) / np.maximum(prob_len[:, 0], 1))
    return float(2.0 ** entropy)


def mcd(mel_a, mel_b, n_cep: int = 13, skip_c0: bool = True) -> float:
    """Mel-cepstral distortion in dB between two aligned (T, M) normalized
    log-mel spectrograms: the cepstra of ``100 * mel`` (normalized features
    are dB / 100) by the ortho DCT-II, then ``(10 / ln 10) * sqrt(2 * sum
    (c_a - c_b)^2)`` over the cepstra past c0 (unless ``skip_c0`` is
    False), averaged over frames. Float64."""
    from ..ops.mel import dct_matrix

    mel_a = np.asarray(mel_a, np.float64) * 100.0
    mel_b = np.asarray(mel_b, np.float64) * 100.0
    dct = dct_matrix(n_cep, mel_a.shape[-1]).astype(np.float64)
    ca = mel_a @ dct.T
    cb = mel_b @ dct.T
    s = 1 if skip_c0 else 0
    diff = ca[..., s:] - cb[..., s:]
    return float(np.mean((10.0 / np.log(10.0)) * np.sqrt(2.0 * np.sum(diff ** 2, axis=-1))))
