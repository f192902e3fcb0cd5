"""V1's int8 level forms: the weights ``pack_levels`` makes for each level
in the int8-dynamic and int8-static tiers, and their tiles. The dynamic
routes' launch plans are replayed in tests/test_torch_dyn_engine.py."""
import numpy as np
import pytest
import torch

from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import act_scales


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.bfloat16()


@pytest.mark.parametrize('tier', ['dynamic', 'static'])
def test_pack_levels_routes_v1_int8(tier):
    """V1's int8 tiers: the wide levels take the ct (dynamic) or tc
    (static) kernel's weights; the narrow ones the int8 phase kernel's
    (L2: p=2 from p_in=1, L3: p=4 from p_in=2, conv_post at L3 only),
    plus the phase-tc kernel's in the static tier."""
    from daft_exprt_torch.models import hifigan as th
    params = th.init_generator_params(0, th.DEFAULT_CONFIG, device='cpu')
    params = _bf16(params)
    scales = None
    if tier == 'static':
        rng = np.random.RandomState(0)
        scales = {i: [tuple(torch.from_numpy(s) for s in e)
                      for e in act_scales(rng, C)]
                  for i, C in enumerate((256, 128, 64, 32))}
    levels = th.pack_levels(params, th.DEFAULT_CONFIG, scales, int8=True)
    assert sorted(levels) == [0, 1, 2, 3]
    for i in (0, 1):
        assert isinstance(levels[i], vk.MrfQ8Weights)
        assert levels[i].dynamic == (tier == 'dynamic')
        assert len(levels[i].chains[0][0]) == (6 if tier == 'dynamic' else 7)
    for i, (p, p_in) in ((2, (2, 1)), (3, (4, 2))):
        lvl = levels[i]
        assert isinstance(lvl, th.NarrowLevel)
        assert (lvl.phase.p, lvl.phase.p_in) == (p, p_in)
        assert lvl.phase.dynamic == (tier == 'dynamic')
        assert (lvl.phase.post is None) == (i == 2)
        assert (lvl.ptc is None) == (tier == 'dynamic')
        # halo_in of V1: 256 columns at both levels
        assert mi._phase_geometry(lvl.phase, 8192, 8192)[:2] == (128, 256)
    assert mi.ct_tile(8192, 256) == 2048 and mi.ct_tile(65536, 128) == 4096
