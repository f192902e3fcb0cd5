"""Hyper-parameter / config system (the port's own copy).

A copy of ``daft_exprt_tpu/hparams.py`` with the same defaults, kept in
this package so that ``daft_exprt_torch`` never imports the JAX package.

Same capability surface as the reference config class
(reference: src/daft_exprt/hparams.py:19-243): hard-coded defaults, kwargs
override with change warnings, derived fields (stats.json ingestion, symbol
table, speaker-ID assignment), invariant checks, JSON round-trip, and pinning
of the feature-extraction-critical parameters.

Deliberate fixes vs the reference (SURVEY.md §7.4): the duplicated
batch_size/nb_iterations/iters_per_checkpoint assignments are collapsed to
their intended values, the developer-local pitch_predictor_path default is
dropped, and the hyper-parameters that the reference only accepts via
config.json kwargs (accent_encoder, lambda_reversal, adv_max_weight,
external_emb_dim, dynamic_stats_subset_size, stats_refresh_interval) get
first-class defaults.
"""
import copy
import json
import logging
import os

from pathlib import Path

from daft_exprt_torch.text.symbols import pad, symbols_english

_logger = logging.getLogger(__name__)

# hyper-params that must match between preprocessing and training
# (reference: src/daft_exprt/extract_features.py:26-28)
FEATURES_HPARAMS = [
    'centered', 'cutoff', 'f0_interval', 'filter_length', 'hop_length',
    'language', 'mel_fmax', 'mel_fmin', 'min_clipping', 'max_f0', 'min_f0',
    'n_mel_channels', 'order', 'sampling_rate', 'symbols', 'uv_cost',
    'uv_interval',
]


class HyperParams:
    def __init__(self, verbose=True, check_mfa=False, **kwargs):
        """Build the config: defaults first, then kwargs overrides, then
        derived fields. ``kwargs`` may carry any attribute by name."""
        # ---- misc ----
        self.minimum_wav_duration = 1000    # ms; shorter audios are dropped

        # ---- mel-spec extraction ----
        self.centered = False               # STFT windows are not centered
        self.min_clipping = 1e-5            # clamp before log-mel
        self.sampling_rate = 22050
        self.mel_fmin = 0
        self.mel_fmax = 8000
        self.n_mel_channels = 80
        self.filter_length = 1024           # FFT size (samples)
        self.hop_length = 256               # hop (samples)

        # ---- pitch tracking (REAPER-equivalent parameters) ----
        self.f0_interval = 0.005
        self.min_f0 = 40
        self.max_f0 = 500
        self.uv_interval = 0.01
        self.uv_cost = 0.9
        self.order = 1
        self.cutoff = 25

        # ---- training ----
        self.seed = 1234
        self.device = 'cuda'                # 'cuda' or 'cpu'
        self.nb_iterations = 370000
        self.iters_per_checkpoint = 10000
        self.iters_check_for_model_improvement = 5000
        self.batch_size = 2                 # per-replica batch size
        self.accumulation_steps = 1
        self.checkpoint = ''

        # ---- loss weights ----
        self.post_mult_weight = 1e-3        # FiLM scalar post-multiplier L2
        self.mel_spec_weight = 1.0

        # ---- accent conversion / augmentation ----
        self.use_concatenation = True
        self.aug_prob = 0.0
        self.max_mel_shift = 3
        self.time_stretch_min = 0.8
        self.time_stretch_max = 1.2
        self.energy_scale_min = 0.7
        self.energy_scale_max = 1.3

        # ---- disentanglement ----
        self.adversarial_weight = 0.2
        self.energy_consistency_weight = 0.05
        self.pitch_consistency_weight = 0.15
        self.pitch_predictor_path = ''
        self.lambda_reversal = 1.0          # GRL backward multiplier
        self.adv_max_weight = 1e-2          # adversarial CE warmup ceiling

        # ---- speaker conditioning ----
        self.external_emb_dim = 192         # ECAPA-TDNN embedding dim
        self.dynamic_stats_subset_size = 10
        self.stats_refresh_interval = 100

        # ---- optimization ----
        self.optimizer = 'adam'
        self.betas = [0.9, 0.98]
        self.epsilon = 1e-9
        self.weight_decay = 1e-6
        self.grad_clip_thresh = float('inf')
        self.initial_learning_rate = 1e-4
        self.max_learning_rate = 1e-3
        self.warmup_steps = 10000

        # ---- model modules ----
        self.phoneme_encoder = {
            'nb_blocks': 4,
            'hidden_embed_dim': 128,
            'attn_nb_heads': 2,
            'attn_dropout': 0.1,
            'conv_kernel': 3,
            'conv_channels': 1024,
            'conv_dropout': 0.1,
        }
        self.accent_encoder = {
            'nb_blocks': 4,
            'hidden_embed_dim': 128,
            'attn_nb_heads': 2,
            'attn_dropout': 0.1,
            'conv_kernel': 3,
            'conv_channels': 1024,
            'conv_dropout': 0.1,
        }
        self.gaussian_upsampling_module = {
            'conv_kernel': 3,
        }
        self.frame_decoder = {
            'nb_blocks': 4,
            'attn_nb_heads': 2,
            'attn_dropout': 0.1,
            'conv_kernel': 3,
            'conv_channels': 1024,
            'conv_dropout': 0.1,
        }

        # ---- execution ----
        self.compute_dtype = 'bfloat16'     # activations dtype under jit
        # dropout-mask PRNG: 'rbg' uses the TPU-native XLA RngBitGenerator
        # (threefry mask generation alone costs ~60% of a train step at
        # B=16/T=1024 — measured 54.3 -> 29.6 ms/it). '' keeps the JAX
        # default (threefry2x32).
        self.prng_impl = 'rbg'
        # pallas whole-row attention kernel for the FFT blocks: 'auto'
        # enables it when running on TPU (tests pinned to CPU keep the XLA
        # path); True/False force. Env DAFT_FUSED_ATTN overrides 'auto'.
        self.fused_attention = 'auto'
        self.mesh_data_axis = 'data'        # DP axis name (JAX's; unread)
        self.mesh_model_axis = 'model'      # TP axis name (JAX's; unread)
        self.length_buckets = [64, 128, 192, 256, 384, 512]       # symbol axis
        self.frame_buckets = [256, 512, 768, 1024, 1536, 2048]    # frame axis

        # ---- must be supplied via kwargs ----
        self.training_files = None
        self.validation_files = None
        self.output_directory = None
        self.language = None
        self.speakers = None

        # ---- derived / optionally supplied ----
        self.stats = {}
        self.symbols = []
        self.n_speakers = 0
        self.speakers_id = []

        # apply kwargs overrides (warn on changes to non-None defaults)
        for key, value in kwargs.items():
            if (hasattr(self, key) and getattr(self, key) is not None
                    and getattr(self, key) != value and verbose):
                _logger.warning(f'Changing parameter "{key}" = {value} '
                                f'(was {getattr(self, key)})')
            setattr(self, key, value)

        for param, value in self.__dict__.items():
            if value is None:
                raise ValueError(f'Hyper-parameter "{param}" is None -- '
                                 f'please specify a value')

        self._set_defaults(verbose=verbose, check_mfa=check_mfa)

    # ------------------------------------------------------------------
    def _set_defaults(self, verbose, check_mfa):
        self.update_mfa_paths(check=check_mfa)

        # ingest stats.json from the output directory if present
        stats_file = os.path.join(self.output_directory, 'stats.json')
        if len(self.stats) == 0 and os.path.isfile(stats_file):
            with open(stats_file) as f:
                self.stats = json.load(f)

        # symbol table
        if len(self.symbols) == 0:
            if self.language == 'english':
                self.symbols = list(symbols_english)
            else:
                raise ValueError(f'Language "{self.language}" has no default '
                                 f'symbol table -- please pass "symbols"')
            if verbose:
                _logger.info(f'Language: {self.language} -- '
                             f'{len(self.symbols)} symbols used')
        self.n_symbols = len(self.symbols)
        if self.symbols.index(pad) != 0:
            raise ValueError(f'Padding symbol "{pad}" must be at index 0')

        # speaker IDs
        if len(self.speakers_id) == 0:
            self.speakers_id = list(range(len(self.speakers)))
        if self.n_speakers == 0:
            # +1 matches the reference's classifier head sizing
            # (reference: src/daft_exprt/hparams.py:199-202)
            self.n_speakers = len(set(self.speakers_id)) + 1

        if self.n_speakers < len(set(self.speakers_id)):
            raise ValueError(f'"n_speakers" ({self.n_speakers}) must be >= '
                             f'number of speakers ({len(set(self.speakers_id))})')
        if len(self.speakers) != len(set(self.speakers)):
            raise ValueError('Speakers are not unique')
        if len(self.speakers) != len(self.speakers_id):
            raise ValueError('"speakers" and "speakers_id" length mismatch')
        if self.filter_length % self.hop_length != 0:
            raise ValueError('filter_length must be a multiple of hop_length')

    # ------------------------------------------------------------------
    def update_mfa_paths(self, check=False):
        """Locate Montreal Forced Aligner pretrained assets for the language."""
        home = str(Path.home())
        base = os.path.join(home, 'Documents', 'MFA', 'pretrained_models')
        self.mfa_dictionary = os.path.join(base, 'dictionary', f'{self.language}.dict')
        self.mfa_g2p_model = os.path.join(base, 'g2p', f'{self.language}_g2p.zip')
        self.mfa_acoustic_model = os.path.join(base, 'acoustic', f'{self.language}.zip')
        if check:
            for p in (self.mfa_dictionary, self.mfa_g2p_model, self.mfa_acoustic_model):
                if not os.path.isfile(p):
                    raise FileNotFoundError(f'Missing MFA asset: {p}')

    def save_hyper_params(self, json_file):
        os.makedirs(os.path.dirname(json_file), exist_ok=True)
        payload = copy.deepcopy(self.__dict__)
        with open(json_file, 'w') as f:
            json.dump(payload, f, indent=4, sort_keys=True)

    @classmethod
    def from_json(cls, json_file, verbose=False, **overrides):
        with open(json_file) as f:
            params = json.load(f)
        params.update(overrides)
        return cls(verbose=verbose, **params)

    def features_config_matches(self, other_config: dict) -> bool:
        """Compare the feature-critical params against a saved config dict."""
        same = True
        for param in FEATURES_HPARAMS:
            if getattr(self, param) != other_config.get(param):
                _logger.warning(
                    f'Feature parameter "{param}" mismatch: now '
                    f'{getattr(self, param)} vs {other_config.get(param)}')
                same = False
        return same
