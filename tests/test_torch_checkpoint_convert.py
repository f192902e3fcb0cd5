"""The port's reference-checkpoint loader for HiFi-GAN generators
(daft_exprt_torch/models/hifigan.py ``convert_torch_generator``,
``load_torch_generator``, ``HiFiGanVocoder(checkpoint_path=...)``) against
the JAX package's ``load_torch_generator``.

A reference-layout ``HiFiGANGenerator`` state dict (``conv_pre``,
``ups.{i}``, ``resblocks.{n}.convs1|convs2.{l}``, ``conv_post``) is built
from ``torch.nn.utils.weight_norm`` convolutions at HiFi-GAN V2's first two
levels' geometry, cut in depth and width, and saved to a file. Both loaders
fold weight norm; the folded kernels agree to float32 rounding (rel 1e-6:
the norms sum in another order). A file that needs unpickling is refused.
"""
import numpy as np
import pytest
import torch
from torch import nn

from daft_exprt_tpu.models import hifigan as jh
from daft_exprt_torch.models import hifigan as th

CFG = {'sampling_rate': 22050, 'upsample_rates': [8, 8],
       'upsample_kernel_sizes': [16, 16], 'upsample_initial_channel': 32,
       'resblock': '1', 'resblock_kernel_sizes': [3, 7],
       'resblock_dilation_sizes': [[1, 3], [1, 3]], 'model_in_dim': 80}


class Refusable:
    """Not a tensor container: loading it needs full unpickling."""


def _reference_state_dict(seed, weight_norm=True):
    torch.manual_seed(seed)
    wn = nn.utils.weight_norm if weight_norm else (lambda m: m)
    c0 = CFG['upsample_initial_channel']
    g = nn.Module()
    g.conv_pre = wn(nn.Conv1d(CFG['model_in_dim'], c0, 7, padding=3))
    g.ups = nn.ModuleList()
    g.resblocks = nn.ModuleList()
    ch = c0
    for u, k in zip(CFG['upsample_rates'], CFG['upsample_kernel_sizes']):
        g.ups.append(wn(nn.ConvTranspose1d(ch, ch // 2, k, u,
                                           padding=(k - u) // 2)))
        ch //= 2
        for rk, dils in zip(CFG['resblock_kernel_sizes'],
                            CFG['resblock_dilation_sizes']):
            rb = nn.Module()
            rb.convs1 = nn.ModuleList([wn(nn.Conv1d(ch, ch, rk, dilation=d))
                                       for d in dils])
            rb.convs2 = nn.ModuleList([wn(nn.Conv1d(ch, ch, rk))
                                       for _ in dils])
            g.resblocks.append(rb)
    g.conv_post = wn(nn.Conv1d(ch, 1, 7, padding=3))
    with torch.no_grad():             # weight_g away from its init norm
        for name, prm in g.named_parameters():
            if name.endswith('weight_g') or name.endswith('bias'):
                prm.mul_(1.0 + torch.rand_like(prm))
    return {k: v.detach().clone() for k, v in g.state_dict().items()}


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize('layout', ['weight_norm', 'nested', 'plain'])
def test_load_torch_generator_matches_jax(tmp_path, layout):
    sd = _reference_state_dict(0, weight_norm=layout != 'plain')
    assert ('conv_pre.weight_v' in sd) == (layout != 'plain')
    assert 'resblocks.3.convs2.1.bias' in sd and 'ups.1.bias' in sd
    path = str(tmp_path / 'g.pt')
    torch.save({'generator': sd} if layout == 'nested' else sd, path)
    got = th.load_torch_generator(path, CFG)
    want = jh.load_torch_generator(path, CFG)
    got_l, want_l = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in got_l] == [k for k, _ in want_l]
    assert len(got_l) == 2 * (2 + 2 + 2 * 2 * 2 * 2)
    for (key, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, key
        assert np.allclose(g.numpy(), w, rtol=1e-6, atol=1e-7), key
    # the converted generator runs and matches the JAX one
    mel = np.random.RandomState(1).randn(1, 80, 8).astype(np.float32)
    with torch.no_grad():
        wav = th.generator_forward(got, torch.from_numpy(mel), CFG)
    ref = np.asarray(jh.generator_forward(want, mel, CFG))
    assert np.abs(wav.numpy() - ref).max() < 1e-5


def test_vocoder_from_checkpoint_path(tmp_path):
    sd = _reference_state_dict(2)
    path = str(tmp_path / 'g.pt')
    torch.save({'state_dict': sd}, path)
    params = th.convert_torch_generator(sd, CFG)
    mel = np.random.RandomState(3).randn(80, 8).astype(np.float32)
    want = th.HiFiGanVocoder(params, CFG, device='cpu').infer(mel)
    voc = th.HiFiGanVocoder(config=CFG, checkpoint_path=path, device='cpu')
    assert np.array_equal(voc.infer(mel), want)
    voc = th.load_hifigan_vocoder(path, config=CFG, device='cpu')
    assert np.array_equal(voc.infer(mel), want)
    with pytest.raises(ValueError, match='checkpoint_path'):
        th.HiFiGanVocoder(config=CFG, device='cpu')


def test_pickled_checkpoint_is_refused(tmp_path):
    path = str(tmp_path / 'bad.pt')
    torch.save({'generator': Refusable()}, path)
    with pytest.raises(ValueError, match='weights_only'):
        th.load_torch_generator(path, CFG)
