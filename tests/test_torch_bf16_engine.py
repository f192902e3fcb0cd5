"""The bf16 block-resident engine's launch plans
(daft_exprt_torch/ops/csrc/mrf_chain_bf16.cuh: ``tc_bf_kernel`` for
``fused_mrf_tc``, ``phase_bf_kernel`` for ``fused_mrf_phase``), replayed on
the CPU block by block.

- Each block's window is emulated as the kernel computes it (its own x
  rows, zero outside the utterance; for the phase kernel its own upsample
  over the window, by the polyphase geometry the kernel is given), then the
  chains by valid convs on that window; the replays must equal the plain
  versions, and the JAX kernels in interpret mode where the replay runs in
  float32.
- Every output sample is written by exactly one block.
- The staged bf16 packing matches the kernel's indexing, the Python
  tables the kernels' compiled configurations, and the Python shared-memory
  layouts that pick block_m the kernels' own layout code (compiled for the
  host with g++ and the declarations in ``tests/cuda_host``).
The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from daft_exprt_tpu.ops import vocoder_kernels as jvk
from daft_exprt_torch.ops import vocoder_kernels as vk

from tests.torch_port_utils import max_abs, mrf_params, rel_l2, to_torch

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
CSRC = Path(vk.__file__).resolve().parent / 'csrc'


def _steps(weights, j, dils):
    return [tuple(t[i] for t in weights[4 * j:4 * j + 4])
            for i in range(len(dils))]


def _chain(win, steps, k, dils, cdt):
    """One chain by valid convs on float32 (B, C, L), the weights per step
    (w1, b1, w2, b2) as packed."""
    w1, b1, w2, b2 = (torch.stack(t) for t in zip(*steps))
    return vk._chain_plain(win, w1, b1, w2, b2, k, dils, cdt)


def _replay_tc(launches, x, weights, cdt):
    """What the ``tc_bf_kernel`` launches compute, block by block; returns
    the output and how often each launch wrote each sample."""
    B, T, C = x.shape
    xc = x.transpose(1, 2).float()
    writes = []
    for j, st in enumerate(launches):
        seen = torch.zeros(B, T, dtype=torch.int64)
        steps = _steps(weights, j, st.dils)
        for b in range(B):
            for i in range(st.n_blocks):
                n0 = i * st.block_m
                s = torch.arange(n0 - st.halo, n0 + st.block_m + st.halo)
                ok = (s >= 0) & (s < T)
                win = torch.where(ok[None, :], xc[b][:, s.clamp(0, T - 1)],
                                  torch.zeros(()))
                y = _chain(win[None], steps, st.k, st.dils, cdt)[0].t()
                n1 = min(n0 + st.block_m, T)
                y = y[:n1 - n0]
                seen[b, n0:n1] += 1
                if st.mode == vk.WRITE:
                    st.sum[b, n0:n1] = y
                    continue
                tot = None
                for a in range(st.n_acc):
                    e = st.sum[a, b, n0:n1]
                    tot = e if tot is None else tot + e
                tot = y if tot is None else tot + y
                st.out[b, n0:n1] = (tot * st.scale).to(st.out.dtype)
        writes.append(seen)
    return launches[-1].out, writes


def _nan_alloc(shape, dtype):
    return torch.full(shape, float('nan'), dtype=dtype)


def _tc_case(C, B, T, cdt, seed=0):
    rng = np.random.RandomState(seed + C + T)
    tp = to_torch(mrf_params(rng, 0, C, KS, DILS, w_scale=0.03))
    w = [t.to(cdt) for t in vk.pack_mrf_tc_weights(tp, 0, KS, DILS)]
    x = torch.from_numpy((rng.randn(B, T, C) * 0.5).astype(np.float32)
                         ).to(cdt)
    return tp, w, x


@pytest.mark.parametrize('C,B,T,slots,cdt', [
    # k = 3 and 7 in two blocks, k = 11 in three
    (128, 2, 300, 132, torch.float32),
    (128, 1, 300, 132, torch.bfloat16),
    # T shorter than the block and than the halo
    (256, 1, 40, 132, torch.float32),
    # several blocks, items over few slots
    (256, 2, 500, 4, torch.float32),
])
def test_tc_bf_plan_replays_plain(C, B, T, slots, cdt):
    _, w, x = _tc_case(C, B, T, cdt)
    launches, out, scratch = vk._tc_bf_plan(x, [None] * 3, KS, DILS,
                                            _nan_alloc, slots)
    assert len(launches) == 3
    assert [st.mode for st in launches] == [vk.WRITE, vk.WRITE, vk.FINAL]
    assert launches[-1].n_acc == 2
    assert all(st.r_smem == vk.TC_BF_CFG[C].r_smem for st in launches)
    assert (scratch > 0) == (not vk.TC_BF_CFG[C].r_smem)
    out, writes = _replay_tc(launches, x, w, cdt)
    # every output sample exactly once per launch
    assert all(bool((n == 1).all()) for n in writes)
    if T > 256:
        assert max(st.n_blocks for st in launches) > 1
    ref = vk.mrf_tc_plain(x, w, KS, DILS)
    assert torch.isfinite(out.float()).all()
    _assert_replay_close(out, ref, cdt)


def _assert_replay_close(out, ref, cdt):
    # float32: the same arithmetic up to the order of a conv's sums. bf16:
    # that order can flip an intermediate's or an output's rounding to
    # bf16 (one ulp is 2^-8 of the value): the kernels' band
    if cdt == torch.float32:
        assert max_abs(out, ref) < 1e-5
    else:
        assert rel_l2(out.float(), ref.float()) < 1e-2


def test_tc_bf_plan_replay_matches_jax_float32():
    """The plan's windows in float32, against the Pallas kernel."""
    C, B, T = 128, 1, 72
    tp, w, x = _tc_case(C, B, T, torch.float32, seed=1)
    launches, _, _ = vk._tc_bf_plan(x, [None] * 3, KS, DILS, _nan_alloc, 132)
    out, _ = _replay_tc(launches, x, w, torch.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, {
        k: {kk: {a: t.numpy() for a, t in vv.items()} for kk, vv in v.items()}
        for k, v in tp.items()})
    ref = np.asarray(jvk.fused_mrf_tc(
        jnp.asarray(x.numpy()), jvk.pack_mrf_tc_weights(jp, 0, KS, DILS), KS,
        DILS, tile=8, interpret=True))
    assert max_abs(out.numpy(), ref) < 1e-5


def _phase_case(C_in, C, B, T_in, post, cdt, seed=0):
    rng = np.random.RandomState(seed + C + T_in)
    params = mrf_params(rng, 0, C, KS, DILS)
    params['ups_0'] = {'w': (rng.randn(C_in, C, 4) * 0.05).astype(np.float32),
                       'b': (rng.randn(C) * 0.05).astype(np.float32)}
    if post:
        params['conv_post'] = {
            'w': (rng.randn(1, C, 7) * 0.1).astype(np.float32),
            'b': (rng.randn(1) * 0.05).astype(np.float32)}
    tp = {k: {kk: (vv.to(cdt) if torch.is_tensor(vv) else
                   {a: t.to(cdt) for a, t in vv.items()})
              for kk, vv in v.items()} for k, v in to_torch(params).items()}
    w = vk.pack_mrf_tc_weights(tp, 0, KS, DILS)
    ups = (tp['ups_0']['w'], tp['ups_0']['b'], 2, 1)
    pst = (tp['conv_post']['w'], tp['conv_post']['b']) if post else None
    # a transposed (B, T, C) input, as the generator hands over from L1
    x = torch.from_numpy((rng.randn(B, T_in, C_in) * 0.5).astype(np.float32)
                         ).to(cdt).transpose(1, 2)
    return params, vk.prepare_mrf(w, KS, DILS, ups, pst), x


def _replay_phase(pl, x, mrf, cdt):
    """What the ``phase_bf_kernel`` launch computes, block by block (its
    x window, the polyphase upsample over its window, the chains on their
    own windows, the mean or conv_post); returns the output and how often
    each sample was written."""
    w_u, b_u, stride, padding = mrf.ups
    _, _, _, _, taps = vk.ups_geometry(w_u.shape[-1], stride, padding)
    B, C_in, T_in = x.shape
    C = w_u.shape[1]
    W = pl.block_m + 2 * pl.hx
    xrows = W // stride + pl.span
    seen = torch.zeros(B, pl.N, dtype=torch.int64)
    for b in range(B):
        for i in range(pl.n_blocks):
            n0 = i * pl.block_m
            base = (n0 - pl.hx) // stride + pl.amin
            q = torch.arange(base, base + xrows)
            ok = (q >= 0) & (q < T_in)
            xq = torch.where(ok[None, :], x[b][:, q.clamp(0, T_in - 1)].float(),
                             torch.zeros(()))
            xq = vk._lrelu(xq).to(cdt).float()
            x0 = torch.empty(C, W)
            for r in range(stride):
                wr = torch.stack([w_u[:, :, j] for j in taps[r]], dim=2)
                y = F.conv1d(xq[None, :, pl.rows[r]:pl.rows[r] + W // stride
                                + pl.ntaps - 1], wr.permute(1, 0, 2).float())
                x0[:, r::stride] = (y[0] + b_u.float()[:, None]).to(cdt).float()
            acc = None
            for j, (k, dils) in enumerate(zip(mrf.kernel_sizes,
                                              mrf.dilations)):
                h = vk.chain_halo(k, dils)
                win = x0[None, :, pl.hx - h - pl.P:pl.hx + pl.block_m + h + pl.P]
                y = _chain(win, _steps(mrf.packed, j, dils), k, dils, cdt)
                acc = y if acc is None else acc + y
            mean = acc * (1.0 / len(mrf.kernel_sizes))
            n1 = min(n0 + pl.block_m, pl.N)
            seen[b, n0:n1] += 1
            if pl.post is None:
                pl.out[b, :, n0:n1] = mean[0, :, :n1 - n0].to(pl.out.dtype)
            else:
                t = vk._lrelu(mean).to(cdt).float()
                y = F.conv1d(t, pl.post[0].to(cdt).float()) + \
                    pl.post[1].float()[:, None]
                pl.out[b, :, n0:n1] = torch.tanh(y[0, :, :n1 - n0]).to(
                    pl.out.dtype)
    return pl.out, seen


@pytest.mark.parametrize('C_in,C,B,T_in,post,slots,cdt', [
    # V1 L2: two blocks per utterance
    (128, 64, 2, 96, False, 132, torch.float32),
    (128, 64, 1, 96, False, 132, torch.bfloat16),
    # V1 L3 with conv_post, one short block
    (64, 32, 1, 40, True, 132, torch.bfloat16),
    # several blocks, no conv_post, and with it
    (64, 32, 2, 300, False, 8, torch.float32),
    (64, 32, 1, 300, True, 8, torch.float32),
    # the utterance shorter than the halo
    (128, 64, 1, 20, False, 132, torch.float32),
])
def test_phase_bf_plan_replays_plain(C_in, C, B, T_in, post, slots, cdt):
    _, mrf, x = _phase_case(C_in, C, B, T_in, post, cdt)
    pl = vk._phase_bf_plan(x, mrf, _nan_alloc, slots)
    assert pl.hx % pl.stride == 0 and pl.block_m % pl.stride == 0
    assert pl.hx >= max(vk.chain_halo(k, d) for k, d in zip(KS, DILS)) + pl.P
    assert pl.P == (3 if post else 0)
    out, seen = _replay_phase(pl, x, mrf, cdt)
    assert bool((seen == 1).all())
    if T_in >= 96:
        assert pl.n_blocks > 1
    ref = vk.mrf_phase_plain(x, mrf.packed, KS, DILS, mrf.ups, mrf.post)
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    _assert_replay_close(out, ref, cdt)


def test_phase_bf_plan_replay_matches_jax_float32():
    """The plan's windows and upsample geometry in float32, against the
    Pallas kernel with its conv_post epilogue."""
    from daft_exprt_tpu.models.hifigan import _pallas_mrf_phase
    C_in, C, T_in = 64, 32, 128
    params, mrf, x = _phase_case(C_in, C, 1, T_in, True, torch.float32, 2)
    pl = vk._phase_bf_plan(x, mrf, _nan_alloc, 132)
    out, _ = _replay_phase(pl, x, mrf, torch.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y, applied = _pallas_mrf_phase(
        jp, jvk.to_phase(jnp.asarray(x.numpy()), 2), 0,
        {'resblock_kernel_sizes': KS, 'resblock_dilation_sizes': DILS}, 4,
        post=jp['conv_post'], ups=dict(jp['ups_0'], stride=2, padding=1,
                                       p_in=2), interpret=True)
    assert applied
    ref = np.asarray(jvk.from_phase(y, 4))
    assert out.shape == ref.shape
    assert max_abs(out.numpy(), ref) < 1e-5


def _cfg(name):
    src = (CSRC / 'mrf_chain_bf16.cuh').read_text()
    body = re.search(r'struct %s \{(.*?)\};' % re.escape(name), src,
                     re.S).group(1)
    return {m[0]: int(m[1]) if m[1].isdigit() else m[1] == 'true'
            for m in re.findall(r'(\w+) = (\w+)', body)}


@pytest.mark.parametrize('C', sorted(vk.TC_BF_CFG))
def test_tc_bf_cfg_matches_kernel(C):
    k = _cfg(f'TcBfCfg<{C}>')
    cfg = vk.TC_BF_CFG[C]
    assert (cfg.nw, cfg.tps, cfg.kch, cfg.nbuf, cfg.r_smem) == (
        k['NW'], k['TPS'], k['KCH'], k['NBUF'], k['R_SMEM'])
    # the planned blocks fit the kernel's shared memory at V1's shapes
    T = {256: 8192, 128: 65536}[C]
    for kk, d in zip(KS, DILS):
        bm = vk.tc_bf_block(C, kk, d, T)
        assert vk._tc_bf_smem(C, cfg, kk, d, bm) <= vk.SMEM_MAX
        assert vk._tc_bf_smem(C, cfg, kk, d, bm + 8) > vk.SMEM_MAX
        assert bm % 8 == 0 and bm >= 64


@pytest.mark.parametrize('C_in,C', sorted(vk.PHASE_BF_CFG))
def test_phase_bf_cfg_matches_kernel(C_in, C):
    k = _cfg(f'PhaseBfCfg<{C_in}, {C}>')
    cfg = vk.PHASE_BF_CFG[C_in, C]
    assert (cfg.nw, cfg.tps, cfg.kch, cfg.utps, cfg.ukch, cfg.nbuf,
            cfg.r_smem) == (k['NW'], k['TPS'], k['KCH'], k['UTPS'],
                            k['UKCH'], k['NBUF'], k['R_SMEM'])


# The kernels' TcBfLayout / PhaseBfLayout, compiled for the host: one line
# in per case ("tc C k n d.. bm" or "ph C_in C n (k n d d d)*n bm hx stride
# span P"), one out ("total fits"), then kSmemMax.
_LAYOUT_MAIN = r"""
#include <cstdio>
#include <cstring>
#include "mrf_chain_bf16.cuh"
using namespace mrf::bfe;
static void steps(StepBf* st, int* n, int* k) {
  scanf("%d %d", k, n);
  for (int i = 0; i < *n; ++i) scanf("%d", &st[i].dil);
}
template <class L> static void put(const L& l) { printf("%zu %d\n", l.total, (int)l.fits); }
int main() {
  char kind[4];
  while (scanf("%3s", kind) == 1) {
    if (!strcmp(kind, "tc")) {
      TcBfParams p = {};
      int C;
      scanf("%d", &C);
      steps(p.steps, &p.n_steps, &p.k);
      scanf("%d", &p.bm);
      if (C == 128) put(TcBfLayout<128>(p)); else put(TcBfLayout<256>(p));
    } else {
      PhaseBfParams p = {};
      int cin, C;
      scanf("%d %d %d", &cin, &C, &p.n_chains);
      for (int j = 0; j < p.n_chains; ++j) steps(p.steps[j], &p.n_steps[j], &p.k[j]);
      scanf("%d %d %d %d %d", &p.bm, &p.hx, &p.stride, &p.span, &p.P);
      if (cin == 128) put(PhaseBfLayout<128, 64>(p)); else put(PhaseBfLayout<64, 32>(p));
    }
  }
  printf("%d\n", kSmemMax);
}
"""


def _kernel_layouts(lines, tmp_path, main=_LAYOUT_MAIN):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no host C++ compiler (g++) to build the kernel layouts')
    (tmp_path / 'layout.cpp').write_text(main)
    exe = tmp_path / 'layout'
    subprocess.run([gxx, '-std=c++17', '-O0', '-I', str(CSRC), '-I',
                    str(Path(__file__).parent / 'cuda_host'), '-o', str(exe),
                    str(tmp_path / 'layout.cpp')], check=True)
    out = subprocess.run([str(exe)], input='\n'.join(lines), text=True,
                         capture_output=True, check=True).stdout.split('\n')
    smem_max = int(out[len(lines)])
    return [tuple(map(int, ln.split())) for ln in out[:len(lines)]], smem_max


def test_bf_smem_layouts_match_kernel(tmp_path):
    """block_m is the largest whose window the kernel's shared memory
    holds: the Python layouts (``_tc_bf_smem``, ``_phase_bf_smem``) and the
    fit the launches check are held to the kernels' own layout code, at
    the planned blocks of V1's levels, one 8-sample step past them, and
    small and odd blocks, with 3 and 2 dilations."""
    cases, lines = [], []
    for C, T in ((256, 8192), (128, 65536)):
        cfg = vk.TC_BF_CFG[C]
        for k in KS:
            for d in ((1, 3, 5), (1, 3)):
                bm0 = vk.tc_bf_block(C, k, d, T)
                for bm in (8, 64, 200, bm0, bm0 + 8):
                    cases.append(('tc', vk._tc_bf_smem(C, cfg, k, d, bm)))
                    lines.append(f'tc {C} {k} {len(d)} {" ".join(map(str, d))} '
                                 f'{bm}')
    stride, span = 2, vk.ups_geometry(4, 2, 1)[3]
    for (C_in, C), T_in in (((128, 64), 65536), ((64, 32), 131072)):
        cfg = vk.PHASE_BF_CFG[C_in, C]
        for P, dils in ((0, DILS), (3, DILS), (3, ((1, 3),) * 3)):
            hx = -(-(max(vk.chain_halo(k, d) for k, d in zip(KS, dils)) + P)
                   // stride) * stride
            ch = ' '.join(f'{k} {len(d)} ' + ' '.join(map(str, d))
                          for k, d in zip(KS, dils))
            bm0 = vk._largest_block(2 * T_in, 8, lambda bm: vk._phase_bf_smem(
                C_in, C, cfg, KS, dils, stride, span, P, hx, bm) is not None)
            for bm in (8, 64, 200, bm0, bm0 + 8):
                cases.append(('ph', vk._phase_bf_smem(
                    C_in, C, cfg, KS, dils, stride, span, P, hx, bm)))
                lines.append(f'ph {C_in} {C} 3 {ch} {bm} {hx} {stride} '
                             f'{span} {P}')
    got, smem_max = _kernel_layouts(lines, tmp_path)
    assert smem_max == vk.SMEM_MAX
    for (kind, py), (total, fits), ln in zip(cases, got, lines):
        if kind == 'tc':
            assert (py, py <= vk.SMEM_MAX) == (total, bool(fits)), ln
        else:       # None: the launch refuses the block
            assert (py is not None) == bool(fits), ln
            assert py is None or py == total, ln
    # both sides of the fit at every planned block
    assert all(got[i + 3][1] and not got[i + 4][1]
               for i in range(0, len(got), 5))


@pytest.mark.parametrize('taps,tps,kch', [(7, 1, 64), (3, 1, 32), (7, 2, 64),
                                          (3, 3, 32), (11, 3, 32)])
def test_pack_stage_bf16_matches_kernel_indexing(taps, tps, kch):
    """Stage s = g*KC + kc, tap tp, output channel n, input channel c of the
    chunk: the kernel's descriptor reads byte 2*c of row n of the tap's
    [n][2*kch bytes] tile at swz<2*kch>, i.e. value (((c >> 3) ^ key[n])
    << 3) | (c & 7) of the row, and applies it to the group's first tap
    (g*tps, or taps - tps for the last group) + tp. Every tap's weights are
    applied exactly once."""
    rng = np.random.RandomState(taps * tps * kch)
    ci, co = 2 * kch, 32
    w = torch.from_numpy(rng.randn(taps, ci, co).astype(np.float32))
    packed = vk.pack_stage_bf16(w, tps, kch).float().numpy()
    wb = w.to(torch.bfloat16).float().numpy()
    G, KC = -(-taps // tps), ci // kch
    assert packed.size == G * KC * tps * co * kch
    key = vk.swizzle_key(co, 2 * kch).numpy()
    st = packed.reshape(G, KC, tps, co, kch)
    applied = np.zeros_like(wb)
    for g in range(G):
        t0 = g * tps if g < G - 1 else taps - tps       # the kernel's
        for kc in range(KC):
            for tp in range(tps):
                for n in range(co):
                    pos = (((np.arange(kch) >> 3) ^ key[n]) << 3) | \
                        (np.arange(kch) & 7)
                    applied[t0 + tp, kc * kch:(kc + 1) * kch, n] += \
                        st[g, kc, tp, n, pos]
    assert np.array_equal(applied, wb)


def test_engine_forms_only_where_the_engine_runs():
    """prepare_mrf keeps the CPU weights plain; ``engine=False`` and
    float32 never stage the engine form (checked on the layout functions
    the card uses)."""
    _, mrf, _ = _phase_case(128, 64, 1, 16, False, torch.bfloat16)
    assert mrf.blk is None and mrf.blk_ups is None and mrf.chains is None
    assert set(vk.TC_BF_CFG) == set(vk.TC_CHANNELS)
    assert set(vk.PHASE_BF_CFG) == set(vk.PHASE_UPS)
