"""Model modules of the port: codebook, encoder, attention, decoder, CBHG,
TTS and the VQVAE composite (text->speech half)."""
