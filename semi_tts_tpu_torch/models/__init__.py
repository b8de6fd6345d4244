"""Model modules of the port: codebook, ASR encoder, TTS encoder,
attention, decoder, CBHG, TTS, the VQVAE composite, the pretraining
language models and the speaker encoder."""
