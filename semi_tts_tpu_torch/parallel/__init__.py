"""Data and model parallelism over `torch.distributed` (counterpart of
`semi_tts_tpu/parallel`): the ``(data, model)`` mesh of ranks, the batch
split over ``data`` and the per-module placement of the parameters over
``model``."""
