"""The frozen operation counts against hand counts and against torch's
own count of the plain reference's products at small shapes."""
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tinybench import REPO, harness

PKG = REPO / 'portbench'


def _mod(path):
    return harness(REPO).load_module(PKG / path)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_generator_counts_by_hand():
    gen = _mod('counts/generator.py')
    cfg = {'upsample_initial_channel': 8, 'upsample_rates': [2, 2],
           'upsample_kernel_sizes': [4, 4], 'resblock': '1',
           'resblock_kernel_sizes': [3], 'resblock_dilation_sizes': [[1, 3]],
           'model_in_dim': 4}
    c = gen.conv_macs(5, cfg)
    # conv_pre 5*4*8*7; L0: ups 5*8*4*4, resblock 10 samples x 4 convs
    # x 4*4*3; L1: ups 10*4*2*4, 20 x 4 x 2*2*3; conv_post 20*2*7
    assert c['edge'] == 5 * 4 * 8 * 7 + 20 * 2 * 7
    assert c['mrf'] == 5 * 8 * 4 * 4 + 10 * 4 * 48 + 10 * 4 * 2 * 4 + \
        20 * 4 * 12
    ops = gen.least_ops([5, 5], cfg, 'int8-static')
    assert ops == {'int8': 4 * c['mrf'], 'bfloat16': 4 * c['edge']}
    assert gen.least_ops([5], cfg, 'float32') == \
        {'float32': 2 * (c['mrf'] + c['edge'])}


@pytest.mark.parametrize('config', ['daft-exprt.hifigan-v1',
                                    'daft-exprt.hifigan-v2'])
def test_generator_counts_match_torch(config):
    gen = _mod('counts/generator.py')
    ref = _mod('reference/generator.py')
    weights = _mod('weights.py')
    cfg = json.loads((PKG / 'configs' / f'{config}.json').read_text())[
        'vocoder']
    p = weights.generator_params(cfg, 1, 'cpu')
    mel = torch.randn(1, 80, 3)
    c = gen.conv_macs(3, cfg)
    assert _flops(lambda: ref.generator(p, mel, cfg)) == \
        2 * (c['mrf'] + c['edge'])


def test_acoustic_counts_match_torch():
    counts = _mod('counts/acoustic.py')
    ref = _mod('reference/acoustic.py')
    acfg = {'phoneme_encoder': {'nb_blocks': 2, 'hidden_embed_dim': 16,
                                'attn_nb_heads': 2, 'conv_kernel': 3,
                                'conv_channels': 32},
            'frame_decoder': {'nb_blocks': 1, 'attn_nb_heads': 2,
                              'conv_kernel': 3, 'conv_channels': 24},
            'n_mel_channels': 8}
    L, T, d = 5, 17, 16
    by_hand = 2 * (2 * (L * 4 * d * d + 2 * L * L * d + 2 * L * d * 32 * 3)
                   + (T * 4 * d * d + 2 * T * T * d + 2 * T * d * 24 * 3)
                   + L * T * d + T * d * 8)
    assert counts.synthesis_ops(L, T, acfg) == by_hand
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)
    sd = {}
    for pre, cfg, n in (('phoneme_encoder', acfg['phoneme_encoder'], 2),
                        ('frame_decoder', acfg['frame_decoder'], 1)):
        cc = cfg['conv_channels']
        for i in range(n):
            b = f'{pre}.block_{i}'
            sd.update({f'{b}.attention.in_proj.weight': r(3 * d, d),
                       f'{b}.attention.in_proj.bias': r(3 * d),
                       f'{b}.attention.out_proj.weight': r(d, d),
                       f'{b}.attention.out_proj.bias': r(d),
                       f'{b}.feed_forward.conv1.conv.weight': r(cc, d, 3),
                       f'{b}.feed_forward.conv1.conv.bias': r(cc),
                       f'{b}.feed_forward.conv2.conv.weight': r(d, cc, 3),
                       f'{b}.feed_forward.conv2.conv.bias': r(d)})
            for ln in ('attention.layer_norm', 'feed_forward.layer_norm'):
                sd[f'{b}.{ln}.weight'] = torch.ones(d)
                sd[f'{b}.{ln}.bias'] = torch.zeros(d)
    for name, (o, i) in {'spk_projection.linear_layer': (d, 12),
                         'style_adapter.gammas_predictor.linear_layer':
                             (3 * d, d),
                         'style_adapter.betas_predictor.linear_layer':
                             (3 * d, d),
                         'gaussian_upsampling.range_projection.linear_layer':
                             (1, d),
                         'frame_decoder.projection.linear_layer': (8, d)
                         }.items():
        sd[f'{name}.weight'], sd[f'{name}.bias'] = r(o, i), r(o)
    for proj in ('duration', 'energy', 'pitch'):
        sd[f'gaussian_upsampling.{proj}_projection.conv.weight'] = r(d, 1, 3)
        sd[f'gaussian_upsampling.{proj}_projection.conv.bias'] = r(d)
    sd['phoneme_encoder.symbols_embedding.weight'] = r(10, d)
    model = ref.Acoustic(sd, acfg)
    dur = torch.tensor([[4, 3, 4, 3, 3]])
    flops = _flops(lambda: model.infer(
        torch.randint(1, 10, (1, L)), dur.float() * 0.01, dur,
        r(1, L), r(1, L), torch.tensor([L]), torch.tensor([T]), T,
        r(1, 12), r(1, d)))
    # torch also counts the speaker and style projections, the three
    # prosody projections and the range projection, which the frozen
    # count leaves out
    small = 2 * (d * 12 + 2 * 3 * d * d + 3 * L * d * 3 + L * d)
    assert flops == by_hand + small


def test_gan_counts_match_torch():
    counts = _mod('counts/gan.py')
    ref = _mod('reference/gan.py')
    n = 600
    dp, u = {}, {}
    for p in counts.MPD_PERIODS:
        for i, (ci, co) in enumerate(counts.MPD_CHANNELS + [(1024, 1)]):
            name = f'period_{p}.conv_{i}' if i < 5 else \
                f'period_{p}.conv_post'
            k = 5 if i < 5 else 3
            dp[f'{name}.g'] = torch.ones(co, 1, 1, 1)
            dp[f'{name}.v'] = torch.randn(co, ci, k, 1) * 0.01
            dp[f'{name}.b'] = torch.zeros(co)
    for s in range(3):
        for i, (ci, co, k, _st, gr, _pad) in enumerate(counts.MSD_LAYERS):
            name = f'scale_{s}.conv_{i}' if i < 7 else f'scale_{s}.conv_post'
            w = torch.randn(co, ci // gr, k) * 0.01
            if s == 0:
                dp[f'{name}.w'] = w
                u[name.split('.', 1)[1]] = torch.randn(co)
            else:
                dp[f'{name}.g'] = torch.ones(co, 1, 1)
                dp[f'{name}.v'] = w
            dp[f'{name}.b'] = torch.zeros(co)
    y = torch.randn(1, 1, n)
    mpd = _flops(lambda: ref.mpd(dp, y))
    assert mpd == 2 * counts.mpd_macs(n) + _flops(
        lambda: [ref.wn(dp[k[:-2] + '.g'], dp[k]) for k in dp
                 if k.startswith('period') and k.endswith('.v')])
    msd = _flops(lambda: ref.msd(dp, u, y, y, False)) / 2
    sn = _flops(lambda: [ref._sn(dp[f'scale_0.{k}.w'], u[k], False)
                         for k in u])
    assert msd - sn == 2 * counts.msd_macs(n)
    mel = ref.LogMel('cpu')
    assert _flops(lambda: mel(y[:, 0])) == 2 * counts.mel_macs(n)

