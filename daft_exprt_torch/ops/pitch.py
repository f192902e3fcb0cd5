"""Pitch tracking on the card: NCCF + Viterbi voicing decision (port of
``daft_exprt_tpu/ops/pitch.py``).

RAPT/REAPER family, with the binary tracker's protocol as output
(per-sample int16 F0 in Hz, -1 unvoiced): a 255-tap highpass FIR, the
normalised cross-correlation over the lag range [sr/max_f0, sr/min_f0]
(one gathered window per frame, the numerators of every lag as one
depthwise correlation, the lagged energies from a cumulative sum), then a
Viterbi pass over (lags + unvoiced) states with |log lag ratio|
transition costs, in O(lags) per frame (two running minima).

Where the port differs in arithmetic, and why:

- **The scores are computed in float64 and rounded to float32.** The
  highpass convolution and the row reductions pick their summation order
  by shape (cuDNN's algorithm, the reduction's split over blocks), so in
  float32 a row's scores would change in the last bit with the batch it
  is computed in, and a Viterbi decision near a tie with them. In
  float64 that order sits far below float32's rounding: ``frame_f0`` and
  each row of ``batched_frame_f0`` get the same scores, and the card's
  round to the CPU's but where a value lies within ~1e-16 of a float32
  rounding boundary. TF32 plays no part (no float32 convolution or
  matmul).
- **The highpass is a true convolution**, as ``jnp.convolve(..., 'same')``
  computes it: ``F.conv1d`` correlates, so it runs on the flipped taps
  (the FIR is symmetric, but the flip keeps the function right).
- **The Viterbi is float32 and exact**: elementwise adds and minima,
  running minima and first-index argmins, which both frameworks compute
  without rounding differences, so the states equal the JAX package's on
  the same scores. The tie rules are copied: ``_cummin_arg`` keeps the
  *earlier* index on a tie, as JAX's associative scan (``take_a = va <=
  vb``) does, where ``torch.cummin`` would keep the later one; the
  ``<=`` choices between the two envelope sides, between voiced and
  unvoiced predecessors and at the last frame are JAX's.
- **The backtrack is JAX's scan**: it emits each frame's successor state
  (the carry before the gather), so frame t takes the state of frame t +
  1 and the last two frames share one; copied, so the tracks agree.

The Viterbi's forward pass is a loop over frames on the device (about
twenty small ops a frame), bounded by the host's dispatch at long inputs;
its int16 backpointers come to the host in one copy for the backtrack.
"""
import numpy as np
import torch
import torch.nn.functional as F

from daft_exprt_torch.device import resolve_device


def _highpass_fir(sr, cutoff=80.0, numtaps=255):
    """FIR highpass (windowed sinc) — rumble removal like REAPER's."""
    t = np.arange(numtaps) - (numtaps - 1) / 2
    fc = cutoff / (sr / 2)
    lp = np.sinc(fc * t) * fc
    win = np.hamming(numtaps)
    lp = lp * win
    lp /= lp.sum()
    hp = -lp
    hp[(numtaps - 1) // 2] += 1.0
    return hp.astype(np.float32)


def _nccf(x, frame_step, win, min_lag, max_lag, n_frames, a_fact=0.0):
    """Normalized cross-correlation per frame and lag.

    x: (B, N) highpassed signals (float64 for the port's scores). Returns
    (B, n_frames, n_lags) in [-1, 1], in x's dtype. ``a_fact`` (a number
    or (B,)) is RAPT's additive amplitude term in the denominator (Talkin
    1995's A_FACT).

    One (B, F, win + max_lag + 1) gather of the signal, the numerators of
    every lag as one depthwise correlation over B x F groups (each frame
    its own kernel), the lagged energies from a cumulative sum.
    """
    B = x.shape[0]
    ext_len = win + max_lag + 1
    starts = torch.arange(n_frames, device=x.device) * frame_step
    idx = starts[:, None] + torch.arange(ext_len, device=x.device)[None, :]
    ext = x[:, idx]                                       # (B, F, ext_len)
    frames0 = ext[..., :win]                              # (B, F, win)
    e0 = torch.sum(frames0 * frames0, dim=-1)             # (B, F)

    # num[b, f, p] = sum_w frames0[b, f, w] * ext[b, f, w + p]
    G = B * n_frames
    num = F.conv1d(ext.reshape(1, G, ext_len),
                   frames0.reshape(G, 1, win),
                   groups=G).reshape(B, n_frames, max_lag + 2)

    csum = torch.cat([torch.zeros_like(ext[..., :1]),
                      torch.cumsum(ext * ext, dim=-1)], dim=-1)
    lags = torch.arange(min_lag, max_lag + 1, device=x.device)
    e1 = csum[..., lags + win] - csum[..., lags]          # (B, F, n_lags)
    a_fact = torch.as_tensor(a_fact, dtype=x.dtype, device=x.device)
    if a_fact.dim() == 1:
        a_fact = a_fact[:, None, None]
    return num[..., lags] / (a_fact + torch.sqrt(e0[..., None] * e1) + 1e-9)


def _cummin_arg(vals, idxs):
    """Running (min, argmin carrier) along the last axis, keeping the
    *earlier* position on a tie (JAX's ``take_a = va <= vb``;
    ``torch.cummin`` keeps the later one). ``idxs``: the carrier, shaped
    like ``vals`` or (n,) for every row."""
    cm = torch.cummin(vals, dim=-1).values
    n = vals.shape[-1]
    pos = torch.arange(n, device=vals.device).expand_as(vals)
    # a position starts a new minimum only where it is strictly below the
    # running minimum before it; a tie keeps the earlier start
    new = torch.ones_like(vals, dtype=torch.bool)
    new[..., 1:] = vals[..., 1:] < cm[..., :-1]
    first = torch.cummax(torch.where(new, pos, 0), dim=-1).values
    return cm, torch.gather(idxs.expand_as(vals), -1, first)


def _backtrack(backptrs, last):
    """JAX's reverse scan over the backpointers (F - 1, B, S): frame F - 1
    takes ``last`` and frame t < F - 1 the carry before gathering
    ``backptrs[t]``, i.e. its successor's state. The backpointers come to
    the host in one copy and the scan runs there, so the device launches
    scale with the forward steps alone; the states go back to ``last``'s
    device."""
    bps = backptrs.cpu().numpy()
    state = last.cpu().numpy().astype(np.int64)
    n = bps.shape[0] + 1
    rows = np.arange(state.shape[0])
    states = np.empty((state.shape[0], n), dtype=np.int64)
    states[:, n - 1] = state
    for t in range(n - 2, -1, -1):
        states[:, t] = state
        if t:
            state = bps[t, rows, state]
    return torch.from_numpy(states).to(last.device)


def _backptrs(n_f, B, S, dev):
    """Backpointer storage for ``n_f`` frames over ``S`` states: int16,
    a quarter of int64's bytes (311 MB -> 78 MB at B = 32 x 2384 frames x
    510 states)."""
    assert S <= np.iinfo(np.int16).max, S
    return torch.empty((max(n_f - 1, 0), B, S), dtype=torch.int16,
                       device=dev)


def _viterbi(ncc, log_lags, uv_cost, n_lags, local_uv=None):
    """Viterbi over (n_lags + 1) states (last = unvoiced) with the
    |log lag ratio| voiced transition cost, in O(n_lags) per frame.

    min_i(prev[i] + |u_j - u_i|) is a 1D lower envelope: split on i <= j /
    i >= j and each side is a running min of (prev -/+ u). ncc: (F,
    n_lags) or (B, F, n_lags) float32; log_lags: (n_lags,); ``local_uv``:
    per-frame local cost of the unvoiced state ((F,) or (B, F); None: the
    constant ``uv_cost``). Returns the best states, (F,) or (B, F).
    """
    single = ncc.dim() == 2
    if single:
        ncc = ncc[None]
        local_uv = None if local_uv is None else local_uv[None]
    B, n_f, _ = ncc.shape
    dev, dt = ncc.device, ncc.dtype
    u = log_lags.to(dev, dt)
    local_v = 1.0 - ncc                                   # (B, F, n_lags)
    switch = torch.tensor(float(uv_cost), dtype=dt, device=dev)
    if local_uv is None:
        local_uv = switch.expand(B, n_f)
    idx0 = torch.arange(n_lags, device=dev)
    idx0_rev = idx0.flip(0)
    unvoiced = torch.tensor(n_lags, device=dev)

    prev_v, prev_uv = local_v[:, 0], local_uv[:, 0]
    bps = _backptrs(n_f, B, n_lags + 1, dev)
    for t in range(1, n_f):
        # lower envelope of prev_v under |u_j - u_i|
        fwd_v, fwd_i = _cummin_arg(prev_v - u, idx0)
        fwd = fwd_v + u                                   # best i <= j
        bwd_v, bwd_i = _cummin_arg((prev_v + u).flip(-1), idx0_rev)
        bwd = bwd_v.flip(-1) - u                          # best i >= j
        env = torch.minimum(fwd, bwd)
        env_i = torch.where(fwd <= bwd, fwd_i, bwd_i.flip(-1))
        # from unvoiced
        from_uv = (prev_uv + switch)[:, None]
        new_v = torch.minimum(env, from_uv) + local_v[:, t]
        bps[t - 1, :, :n_lags] = torch.where(env <= from_uv, env_i, unvoiced)
        # unvoiced state
        best_v, best_v_idx = torch.min(prev_v, dim=-1)    # first index
        enter = best_v + switch
        stay = prev_uv
        new_uv = torch.minimum(stay, enter) + local_uv[:, t]
        bps[t - 1, :, n_lags] = torch.where(stay <= enter, unvoiced,
                                            best_v_idx)
        prev_v, prev_uv = new_v, new_uv

    best_v, best_v_idx = torch.min(prev_v, dim=-1)
    last = torch.where(best_v <= prev_uv, best_v_idx, unvoiced)
    states = _backtrack(bps, last)
    return states[0] if single else states


def _viterbi_dense(ncc, trans_cost, uv_cost, n_lags, local_uv=None):
    """Dense Viterbi over (n_lags + 1) states; state n_lags = unvoiced.

    The yardstick of the envelope form (O(S^2) per frame). ncc: (F,
    n_lags) or (B, F, n_lags); trans_cost: (n_lags, n_lags); ``local_uv``:
    per-frame unvoiced local cost (None = constant uv_cost). Returns the
    best states, (F,) or (B, F).
    """
    single = ncc.dim() == 2
    if single:
        ncc = ncc[None]
        local_uv = None if local_uv is None else local_uv[None]
    B, n_f, _ = ncc.shape
    dev, dt = ncc.device, ncc.dtype
    switch = torch.tensor(float(uv_cost), dtype=dt, device=dev)
    if local_uv is None:
        local_uv = switch.expand(B, n_f)
    local = torch.cat([1.0 - ncc, local_uv[..., None]], dim=-1)  # (B, F, S)

    S = n_lags + 1
    tc = torch.zeros((S, S), dtype=dt, device=dev)
    tc[:n_lags, :n_lags] = trans_cost.to(dev, dt)
    tc[n_lags, :n_lags] = switch
    tc[:n_lags, n_lags] = switch

    cost = local[:, 0]
    bps = _backptrs(n_f, B, S, dev)
    for t in range(1, n_f):
        total = cost[:, :, None] + tc                     # (B, S, S)
        best, bps[t - 1] = torch.min(total, dim=1)        # first index
        cost = best + local[:, t]
    last = torch.argmin(cost, dim=-1)
    states = _backtrack(bps, last)
    return states[0] if single else states


class PitchTracker:
    """Pitch tracker with REAPER-compatible parameters on ``device``
    (default cuda; raises without CUDA unless ``device='cpu'``)."""

    def __init__(self, hparams, sr=None, device=None):
        self.device = resolve_device(device)
        self.sr = sr or hparams.sampling_rate
        self.min_f0 = hparams.min_f0
        self.max_f0 = hparams.max_f0
        self.f0_interval = hparams.f0_interval
        self.uv_cost = hparams.uv_cost
        self.frame_step = max(1, int(round(self.f0_interval * self.sr)))
        self.min_lag = max(2, int(self.sr / self.max_f0))
        self.max_lag = int(np.ceil(self.sr / self.min_f0))
        self.win = int(0.0075 * self.sr)            # 7.5 ms correlation window
        self.hp = _highpass_fir(self.sr)
        # voiced->voiced transition cost: |log(lag1/lag2)| octave-jump
        # penalty, as the running-min envelope of log_lags in _viterbi
        lags = np.arange(self.min_lag, self.max_lag + 1, dtype=np.float64)
        self.n_lags = self.max_lag - self.min_lag + 1
        dev = self.device
        # F0 of each lag: float32 division on the host, correctly rounded
        # as the JAX package's (torch divides a number by a tensor through
        # the reciprocal, one ulp off for some lags)
        self.lag_hz = torch.tensor(
            np.float32(self.sr) / lags.astype(np.float32), device=dev)
        self.log_lags = torch.tensor(np.log(lags), dtype=torch.float32,
                                     device=dev)
        # RAPT-style doubling cost: bias candidate scores toward shorter
        # periods so exact subharmonics (octave errors) lose ties
        self.octave_cost = torch.tensor(
            0.02 * np.log2(lags / self.min_lag), dtype=torch.float32,
            device=dev)
        # the highpass as a correlation: the taps flipped, in float64
        self._hp_taps = torch.tensor(self.hp[::-1].copy(), device=dev,
                                     dtype=torch.float64)[None, None]
        # RAPT amplitude/voicing constants (Talkin 1995), as tuned in the
        # JAX package against the reference REAPER binary:
        #   a_coef: A_FACT as a fraction of win x mean-square signal level
        #   vo_bias: bias added to max-NCCF to price the unvoiced state
        self.a_coef = 2e-3
        self.vo_bias = 0.0

    def n_frames(self, n_samples):
        return max(1, int(n_samples // self.frame_step))

    def _prepare(self, wavs):
        """(B, N) float32 on the device -> highpassed and zero-padded (B,
        N') float64, n_frames, mean_sq (B,) float32 (the mean squared
        highpassed signal, before the padding)."""
        n = wavs.shape[-1]
        half = (len(self.hp) - 1) // 2
        x = F.conv1d(F.pad(wavs.double()[:, None], (half, half)),
                     self._hp_taps)[:, 0]                  # 'same' length
        mean_sq = torch.mean(x * x, dim=-1).float()
        pad_needed = self.win + self.max_lag + 1
        n_frames = self.n_frames(n)
        total = (n_frames - 1) * self.frame_step + pad_needed
        if total > n:
            x = F.pad(x, (0, total - n))
        return x, n_frames, mean_sq

    def _scores(self, x, n_frames, mean_sq):
        """Highpassed (B, N') float64 -> float32 Viterbi inputs: the
        octave-biased scores (B, F, n_lags) and the unvoiced local cost
        (B, F) from the raw scores."""
        a_fact = (self.a_coef * self.win) * mean_sq        # float32, as JAX
        ncc = _nccf(x, self.frame_step, self.win, self.min_lag, self.max_lag,
                    n_frames, a_fact=a_fact.double()).float()
        local_uv = self.vo_bias + torch.clamp(ncc.max(dim=-1).values,
                                              min=0.0)
        return ncc - self.octave_cost, local_uv

    def _f0(self, states):
        hz = self.lag_hz[torch.clamp(states, 0, self.n_lags - 1)]
        return torch.where(states < self.n_lags, hz, torch.zeros_like(hz))

    def _pipeline(self, wavs):
        x, n_frames, mean_sq = self._prepare(wavs)
        ncc, local_uv = self._scores(x, n_frames, mean_sq)
        states = _viterbi(ncc, self.log_lags, self.uv_cost, self.n_lags,
                          local_uv=local_uv)
        return self._f0(states)

    @torch.no_grad()
    def batched_frame_f0(self, wavs):
        """wavs: (B, N) float32 (host array or tensor) -> (B, n_frames) F0
        in Hz (0 = unvoiced) on the device: one batched pass, the Viterbi
        stepping every row at once."""
        w = torch.tensor(np.asarray(wavs, dtype=np.float32)) \
            if not isinstance(wavs, torch.Tensor) else wavs.float()
        return self._pipeline(w.to(self.device))

    @torch.no_grad()
    def frame_f0(self, wav):
        """wav: (N,) float32 -> host (n_frames,) F0 in Hz (0 = unvoiced),
        one value per f0_interval."""
        w = torch.tensor(np.asarray(wav, dtype=np.float32))
        return self._pipeline(w[None].to(self.device))[0].cpu().numpy()

    def per_sample_f0(self, wav):
        """Binary-protocol output: per-sample int-valued F0 in Hz, -1 when
        unvoiced, length == len(wav)."""
        f0 = self.frame_f0(wav)
        per_sample = np.repeat(f0, self.frame_step)[:len(wav)]
        if len(per_sample) < len(wav):
            per_sample = np.pad(per_sample, (0, len(wav) - len(per_sample)),
                                mode='edge')
        out = np.where(per_sample > 0, np.rint(per_sample), -1.0)
        return out.astype(np.int16)
