"""The benchmark's plain reference of semi-supervised multi-speaker TTS
(arXiv 2005.08024, the upstream ttaoREtw/semi-tts model): plain PyTorch and
NumPy, fp32, importing nothing of the program under test."""
