"""daft_exprt_torch — the PyTorch/CUDA port of ``daft_exprt_tpu``.

The port runs on an NVIDIA Hopper card (H100): the serving entry point
(``generate.py``), the acoustic model's inference and training forward
(``models/daft_exprt.py``), its training (``train.py``: one process on
one card, or data-parallel over ranks), the HiFi-GAN V1 and V2 generators in their float32, bf16,
int8-static and int8-dynamic tiers (``models/hifigan.py``), and the audio
front end (log-mel, energy and pitch extraction, corpus pre-processing,
reference recordings for accent conversion, Griffin-Lim), vocoder GAN
fine-tuning (``fine_tune.py``, ``vocoder_finetune.py``, data-parallel
too), the channel-parallel vocoder and the text and alignment front end
(host code), and the command-line tools (``scripts/``), with the Pallas
kernels of the JAX package replaced by hand-written CUDA kernels
(``ops/csrc``).

It imports ``torch`` and numpy only: never ``jax``, ``flax`` or anything of
``daft_exprt_tpu``. Every entry point takes ``device=`` and defaults to
``cuda``; it raises when no CUDA device is present unless the caller asked
for ``'cpu'`` (the CPU runs each kernel's plain PyTorch version).

Layout:
    text/      symbol table, number and text cleaners (copies)
    hparams.py config system (copy of the JAX package's)
    bridge.py  JAX param pytrees (as numpy) -> torch state dicts
    frontend/  WAV I/O, duration quantization, markers, TextGrids and the
               Montreal Forced Aligner's driver, ECAPA embeddings
               (copies); pitch extraction (native binary or the card's
               tracker), feature extraction driver, Griffin-Lim
    data/      dataset, collation, iterators, dynamic speaker stats, set
               lists and feature stats (copies)
    utils/     chunker, Timer, multiprocessing pool, plots (copies),
               TensorBoard logger, profiling (torch.profiler traces,
               timers, an audio-seconds/s counter)
    ops/       CUDA kernels (csrc/), their build step and PyTorch wrappers;
               gradient reversal; log-mel (mel.py) and the NCCF + Viterbi
               pitch tracker (pitch.py), plain PyTorch on the card
    models/    acoustic model, pitch predictor (frozen, or in training),
               HiFi-GAN generator, its MPD and MSD discriminators
    loss.py    the five-term training loss
    parallel/  train and eval steps (one device or data-parallel), LR
               schedule, optimizer; process groups and the (data, model)
               mesh, the rank launcher, the channel-parallel vocoder, the
               dry run
    checkpoint.py  torch-native checkpoints with an ``extra`` payload
               (weights_only loads); the reference implementation's .pt
               checkpoints, told apart by content
    train.py   training driver: train, validate, resume
    generate.py  synthesis entry point: the phonemizer, prosody transforms,
               bucketed Synthesizer, generate_mel_specs,
               extract_reference_parameters
    fine_tune.py  (predicted-mel, wav) pairs from a trained acoustic model
    vocoder_finetune.py  HiFi-GAN GAN fine-tuning: steps, driver
    scripts/   the command-line tools, ``python -m
               daft_exprt_torch.scripts.<name>`` (one per top-level
               script of the same name)
"""

__version__ = '0.1.0'
