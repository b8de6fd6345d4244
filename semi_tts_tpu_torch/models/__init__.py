"""Model modules of the port: codebook, ASR encoder, TTS encoder,
attention, decoder, CBHG, TTS and the VQVAE composite."""
