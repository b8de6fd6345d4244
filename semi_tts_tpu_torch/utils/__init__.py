"""Small helpers (phonological attribute table)."""
