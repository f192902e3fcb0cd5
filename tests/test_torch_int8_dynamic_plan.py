"""CPU replay of the launch plan of the int8-dynamic step route in
daft_exprt_torch/ops/mrf_int8.py (``_ct_plan``): each launch of
``conv_dyn_kernel`` is emulated with the arithmetic its source states, on
NaN-filled buffers and amax words from 0 (as the wrappers zero them), and
the result must equal the plain version; and V1's int8 level forms. The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from daft_exprt_torch.ops import mrf_int8 as mi
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.test_torch_int8 import KS, DILS, act_scales, unit_level
from tests.test_torch_int8_plan import _nan_alloc
from tests.torch_port_utils import to_torch


def _read(v, b, t, n0, n1, C):
    """Samples [n0, n1) of segment (b, t) of a SegView, float32 (n, C)."""
    flat = v.t.reshape(-1)
    n = torch.arange(n0, n1)
    g = n + t * v.vstep
    valid = ((g >= v.lo) & (g < v.hi))[:, None]
    idx = (b * v.bs + t * v.ts + (n + v.off) * C)[:, None] + torch.arange(C)
    return torch.where(valid, flat[idx.clamp(0, flat.numel() - 1)].float(),
                       torch.zeros(()))


def _emulate_dyn(st, amax, n_t, C):
    """What one ``conv_dyn_kernel`` launch computes, segment by segment."""
    w, sw, bias = st.weights
    h = st.d * ((st.k - 1) // 2)
    n = st.n_hi - st.n_lo
    dst = st.dst.t.reshape(-1)
    for seg in range(amax.shape[1]):
        b, t = divmod(seg, n_t)
        a = amax[st.a_in, seg].clamp(min=1e-30)
        inp = vk._lrelu(_read(st.src, b, t, st.n_lo - h, st.n_hi + h, C))
        q = torch.round(inp * (torch.full((), 127.0) / a)).to(torch.int8)
        acc = vk._int_conv(q[None], w, st.d, n)[0]
        v = vk._fma(acc.float(), sw * (a * (1.0 / 127.0)), bias)
        if st.res is not None:
            v = _read(st.res, b, t, st.n_lo, st.n_hi, C) + v
        if st.a_out is not None:
            amax[st.a_out, seg] = torch.maximum(
                amax[st.a_out, seg], vk._lrelu(v).abs().max())
        rows = torch.arange(st.n_lo, st.n_hi)
        idx = (b * st.dst.bs + t * st.dst.ts + (rows + st.dst.off) * C
               )[:, None] + torch.arange(C)
        if st.mode == vk.WRITE:
            dst[idx] = v
        elif st.mode == vk.ADD:
            dst[idx] = dst[idx] + v
        else:
            tot = dst[idx] + v if st.has_acc else v
            fin, fbs, fts, fns, fcs = st.fin
            fidx = (b * fbs + t * fts + rows * fns)[:, None] + \
                torch.arange(C) * fcs
            fin.reshape(-1)[fidx] = (tot * st.scale).to(fin.dtype)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.bfloat16()


def _ct_level(seed, C):
    rng = np.random.RandomState(seed)
    tp = _bf16(to_torch(unit_level(rng, 0, C)))
    return rng, mi.prepare_mrf_ct_q8(mi.quantize_mrf_ct_weights(
        mi.pack_mrf_weights(tp, 0, KS, DILS)), KS, DILS)


def test_ct_launch_plan_replays_plain():
    """Two utterances of three tiles: the first tile's window reaches into
    the zero padding; one loud tile moves its scales."""
    C, tile = 32, 128
    rng, mrf = _ct_level(4, C)
    x = torch.from_numpy((rng.randn(2, 3 * tile, C) * 0.5).astype(np.float32)
                         ).bfloat16()
    x[1, tile:2 * tile] *= 6.0
    plan = mi._ct_plan(x, mrf.chains, KS, DILS, tile, _nan_alloc)
    assert len(plan.steps) == 18
    plan.amax.zero_()
    n_t, halo = plan.n_tiles, plan.halo
    for seg in range(plan.amax.shape[1]):
        b, t = divmod(seg, n_t)
        win = _read(mi.SegView(x, x.shape[1] * C, tile * C, 0, 0, x.shape[1],
                               tile), b, t, -halo, tile + halo, C)
        plan.amax[0, seg] = vk._lrelu(win).abs().max()
    for st in plan.steps:
        _emulate_dyn(st, plan.amax, n_t, C)
    ref = mi.mrf_ct_q8_plain(x, mrf, tile)
    assert torch.isfinite(plan.out.float()).all()
    assert torch.equal(plan.out, ref)


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
