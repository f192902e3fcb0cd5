"""The audio front end: WAV I/O, duration quantization and markers (numpy
and scipy copies of the JAX package's ``frontend`` modules), pitch
extraction, the feature-extraction driver and Griffin-Lim; the Montreal
Forced Aligner's orchestration and its TextGrid parser, ECAPA speaker
embeddings (copies)."""
