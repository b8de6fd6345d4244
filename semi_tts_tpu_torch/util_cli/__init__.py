"""Command-line tools around the CLI: `import_reference_ckpt` (an upstream
``.pth`` to a checkpoint of this layout) and `gen_wav_from_specgram`
(batched Griffin-Lim of ``--gen-specgram``'s spectrograms)."""
