"""The port's command-line tools, one module per script of the top-level
``scripts/`` directory of the same name, each run as
``python -m daft_exprt_torch.scripts.<name>`` with a ``main(argv=None)``:

- ``synthesize``: symbol prosody -> mels -> waveforms (HiFi-GAN tiers or
  Griffin-Lim), the style-bank demo, accent and speaker embeddings;
- ``training``: ``pre_process`` / ``train`` / ``fine_tune``;
- ``adapt_speaker``, ``adapt_accent``: few-shot adaptation with a
  memorized embedding in the checkpoint's ``extra``;
- ``train_pitch_predictor``: the predictor the pitch-consistency loss reads;
- ``make_style_bank``, ``compute_spk_stats_from_prosody``,
  ``precompute_ECAPA_spk_embeddings``, ``extract_symbol_prosody``,
  ``format_dataset``, ``grid_search_accent``;
- ``qualify_int8``: the int8 tiers against float32 on GAN-trained weights,
  gated;
- ``evaluation.compute_wer_and_accent_metrics``,
  ``evaluation.compare_pitch_curves``;
- ``hifigan_sanity_check``, ``verify_mel_spec``,
  ``generate_augmentation_examples``, ``visualize_pitch_prediction``,
  ``verify_pitch_predictor_shape``, ``analyze_embedding_manifold``;
- ``benchmarks.convert_prosody_with_llm``.

Each takes the flags of its counterpart with the same names and defaults,
plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). A tool resolves its device before it reads or writes a file.
"""
