"""Matplotlib renderers of the TensorBoard images (counterpart of
`semi_tts_tpu/utils/viz.py`): spectrogram and alignment heatmaps
(`feat_to_fig`) and token-usage bar charts (`data_to_bar`), each returned as
an (H, W, 3) float array in [0, 1] with the data format ``"HWC"``.
Matplotlib (with the ``Agg`` backend) is imported when a figure is drawn.
"""

from __future__ import annotations

import numpy as np


def _save_canvas(data, meta=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(16, 10))
    if meta is None:
        ax.imshow(data, aspect="auto", origin="lower")
    else:
        ax.bar(meta[0], data[0], tick_label=meta[1], fc=(0, 0, 1, 0.5))
        ax.bar(meta[0], data[1], tick_label=meta[1], fc=(1, 0, 0, 0.5))
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3] / 255.0
    plt.close(fig)
    return buf


def feat_to_fig(feat):
    """feat: (T, D) array -> (HWC image of its transpose, "HWC")."""
    if feat is None:
        return None
    return _save_canvas(np.asarray(feat).T), "HWC"


def usage_shares(counts, tok_size: int, zero_pad_tok: bool = True):
    """Each token's share of a usage count vector (``counts[i]``: the
    occurrences of token i), over ``tok_size`` tokens; the pad token's share
    set to 0 with ``zero_pad_tok``."""
    counts = np.asarray(counts, np.int64)
    total = max(int(counts.sum()), 1)
    counts = np.pad(counts, (0, max(0, tok_size - len(counts))))[:tok_size]
    shares = [int(c) / total for c in counts]
    if zero_pad_tok:
        shares[0] = 0
    return shares


def data_to_bar(counts, gt_counts, tok_size: int, tick, zero_pad_tok=True):
    """Bar chart of the predicted and the true token usage, from their count
    vectors (`numpy.bincount` of the tokens); None when no true token was
    counted."""
    if int(np.sum(gt_counts)) == 0:
        return None
    shares = (usage_shares(counts, tok_size, zero_pad_tok),
              usage_shares(gt_counts, tok_size, zero_pad_tok))
    return _save_canvas(shares, meta=(range(tok_size), tick)), "HWC"
