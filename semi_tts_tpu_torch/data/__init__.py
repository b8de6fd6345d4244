"""Data helpers the serving path needs (phoneme text codec)."""
