"""Host-side data layer (counterpart of `semi_tts_tpu/data`): the phoneme
text codec, corpora, the bucketed batch loader and WAV I/O."""

from __future__ import annotations


def load_dataset(n_jobs, use_gpu, pin_memory, corpus, audio, inference_stage=False, seed=0,
                 device=None, shard_id=None, num_shards=None):
    """Loaders, featurizer and tokenizer for a solver: ``(unpair_set,
    pair_set, dev_set, test_set, featurizer, tokenizer, data_msg)``. The
    featurizer's tables live on ``device`` (the card unless it is "cpu");
    the loaders carry raw padded waveforms on the host. ``n_jobs``,
    ``use_gpu`` and ``pin_memory`` are accepted for the CLI's sake (one
    prefetch thread a loader does the decoding).

    Several processes: ``shard_id``/``num_shards`` default to this
    process's rank and the world size of `torch.distributed` (one process:
    0 and 1), so each process's TRAIN loaders iterate an interleaved slice
    of the identically seeded batch stream; the solvers pass their mesh's
    data coordinate instead. Dev and test loaders stay unsharded: every
    process walks the whole split, so evaluation is the same everywhere."""
    if num_shards is None:
        from ..parallel.mesh import world

        shard_id, num_shards = world()
    elif shard_id is None:
        shard_id = 0
    from ..ops.features import AudioConfig, AudioFeaturizer
    from .corpus import create_dataset
    from .loader import TTSLoader
    from .text import load_text_encoder

    data_msg = []
    acfg = AudioConfig(
        num_freq=audio["num_freq"], num_mels=audio["num_mels"],
        frame_length_ms=audio["frame_length_ms"], frame_shift_ms=audio["frame_shift_ms"],
        preemphasis_coeff=audio["preemphasis_coeff"], sample_rate=audio["sample_rate"],
        use_linear=audio["use_linear"], snr_range=tuple(audio["snr_range"]),
        time_stretch_range=tuple(audio["time_stretch_range"]),
    )
    featurizer = AudioFeaturizer(acfg, device)
    feat_type = "Mel/Linear" if acfg.use_linear else "Mel"
    data_msg.append(f"Audio spec.| Feature type = {feat_type}\t\t| Feature dim = "
                    f"({acfg.num_mels}, {acfg.num_freq if acfg.use_linear else None})")

    tokenizer = load_text_encoder("phoneme", vocab_file=corpus["vocab_file"],
                                  map_table=corpus["map_table"])
    data_msg.append(f"Text spec. | Token type = {tokenizer.token_type}\t| "
                    f"Vocab size = {tokenizer.vocab_size}")

    unpair_ds, pair_ds, dev_ds, test_ds, set_msg = create_dataset(
        **corpus, inference_stage=inference_stage)
    data_msg.extend(set_msg)

    def mk(ds, train):
        if ds is None:
            return None
        train = train and not inference_stage
        return TTSLoader(ds, tokenizer, shuffle=train, drop_last=train, seed=seed,
                         sample_rate=acfg.sample_rate, shard_id=shard_id if train else 0,
                         num_shards=num_shards if train else 1)

    unpair_set = mk(unpair_ds, True)
    pair_set = mk(pair_ds, True)
    dev_set = mk(dev_ds, False)
    test_set = mk(test_ds, False) if inference_stage else None

    data_msg.append("Augment    | Speed rate = {}\t| S/N rate = {}".format(
        list(acfg.time_stretch_range), list(acfg.snr_range)))
    return unpair_set, pair_set, dev_set, test_set, featurizer, tokenizer, data_msg
