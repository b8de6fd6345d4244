"""Tensor ops: recurrences, STFT pieces, audio features, Griffin-Lim."""
