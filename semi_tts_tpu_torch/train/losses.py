"""Spectrogram regression losses (counterpart of
`semi_tts_tpu/train/losses.py`): L1 or MSE over the whole padded batch, a
50/50 mix with the loss below 3 kHz for linear spectrograms, and a
0.5-weighted delta-t term for mel spectrograms."""

from __future__ import annotations

CUTOFF_FREQ = 3000  # Hz


def freq_loss(pred, label, *, sample_rate, n_mels, loss="mse", differential_loss=True,
              emphasize_linear_low=True, p=1.0):
    """pred, label (B, T, dim); a mel spectrogram when dim == n_mels, else a
    linear one."""
    if loss == "l1":
        crit = lambda a, b: (a - b).abs().mean()
    elif loss == "mse":
        crit = lambda a, b: ((a - b) ** 2).mean()
    else:
        raise NotImplementedError(loss)
    dim = pred.shape[-1]
    loss_all = crit(p * pred, p * label)
    if dim != n_mels and emphasize_linear_low:
        n_priority = int(dim * (CUTOFF_FREQ / (sample_rate / 2)))
        loss_all = 0.5 * loss_all + 0.5 * crit(p * pred[:, :, :n_priority],
                                               p * label[:, :, :n_priority])
    if dim == n_mels and differential_loss:
        pd = pred[:, 1:, :] - pred[:, :-1, :]
        ld = label[:, 1:, :] - label[:, :-1, :]
        loss_all = loss_all + 0.5 * crit(p * pd, p * ld)
    return loss_all
