"""Composite training loss (PyTorch port of ``daft_exprt_tpu/loss.py``).

All five terms of the reference loss:
  1. mel reconstruction L1 + L2, per-frame normalised;
  2. adversarial speaker cross-entropy with a linear warmup of its weight;
  3. L2 of the FiLM scalar post-multipliers;
  4. energy consistency: MSE of the smoothed linear-mel L2 norms;
  5. pitch consistency: the frozen ``PitchPredictor`` on the predicted mels,
     masked to voiced frames.
"""
import torch
import torch.distributed as dist


def adversarial_weight(iteration, warmup_steps, adv_max_weight):
    """Linear warmup of the adversarial cross-entropy weight."""
    w = (iteration * warmup_steps ** -1.5 * adv_max_weight
         / warmup_steps ** -0.5)
    return min(adv_max_weight, w)


def _avg_pool5(x):
    """torch AvgPool1d(k=5, s=1, p=2, count_include_pad=True) over (B, T),
    as five shifted adds."""
    pad = torch.nn.functional.pad(x, (2, 2))
    return (pad[:, :-4] + pad[:, 1:-3] + pad[:, 2:-2] + pad[:, 3:-1]
            + pad[:, 4:]) / 5.0


def _softmax_ce(logits, labels):
    logits = logits - torch.amax(logits, dim=-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(logits), dim=-1))
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.mean(logz - gold)


# what a data-parallel compute_loss sums over the ranks before its
# divisions, in this order: the ranks with rows, the rows, sum(out_lens),
# sum(voiced mask)
GLOBAL_STATS = ('ranks', 'rows', 'frames', 'voiced')


def compute_loss(outputs, targets, iteration, cfg, pitch_predictor=None,
                 group=None):
    """outputs: dict from ``DaftExprt.forward``; targets: dict with
    mel_specs, output_lengths, speaker_ids, frames_energy_raw,
    frames_pitch_raw. ``iteration`` a number (the adversarial warmup);
    ``cfg`` from :func:`loss_cfg_from_hparams`; ``pitch_predictor`` a
    frozen ``PitchPredictor`` or None. Returns (loss, {term: value}).

    ``group``: the process group over whose ranks the batch is split (the
    data-parallel step). Each term is then this rank's share of the term
    over the global batch, so the ranks' losses and terms sum to the global
    ones, as the JAX step computes them in one program: a mean over rows
    weighs by this rank's rows over the global rows, the parameters' term
    (the post-multipliers) by 1 / ranks, and the consistency terms divide
    by the global sum(out_lens) and sum(mask), which one all-reduce of
    ``GLOBAL_STATS`` gives before the divisions. A rank without rows (the
    last batches of uneven validation shards) joins that all-reduce with
    zeros instead of calling this."""
    mel_preds = outputs['mel_preds']                      # (B, n_mel, T)
    mel_tgt = targets['mel_specs']
    out_lens = targets['output_lengths'].float()
    n_mel = cfg['n_mel_channels']
    zero = mel_preds.new_zeros(())
    pitch_on = (pitch_predictor is not None
                and cfg['pitch_consistency_weight'] > 0
                and targets.get('frames_pitch_raw') is not None)
    if pitch_on:
        gt = targets['frames_pitch_raw']
        len_mask = torch.arange(gt.shape[-1], device=gt.device)[None, :] < \
            out_lens[:, None]
        voiced = (len_mask & (gt != 0.0)).float()
    if group is None:
        row_share = param_share = None
        len_sum = torch.sum(out_lens)
        mask_sum = torch.sum(voiced) if pitch_on else None
    else:
        stats = torch.stack([out_lens.new_tensor(1.0),
                             out_lens.new_tensor(float(out_lens.shape[0])),
                             torch.sum(out_lens),
                             torch.sum(voiced) if pitch_on else zero.float()])
        dist.all_reduce(stats, group=group)
        row_share = out_lens.shape[0] / stats[1]
        param_share = 1.0 / stats[0]
        len_sum, mask_sum = stats[2], stats[3]

    def share(x, s):
        return x if s is None else x * s

    # 1. adversarial speaker loss
    speaker_preds = outputs.get('speaker_preds')
    if speaker_preds is not None:
        ce_raw = share(_softmax_ce(speaker_preds, targets['speaker_ids']),
                       row_share)
        speaker_loss = adversarial_weight(
            float(iteration), cfg['warmup_steps'], cfg['adv_max_weight']) \
            * ce_raw
    else:
        ce_raw = speaker_loss = zero

    # 2. FiLM post-multiplier L2
    post = outputs.get('post_multipliers')
    if cfg['post_mult_weight'] != 0.0 and post is not None:
        post_mult_loss = share(cfg['post_mult_weight']
                               * torch.linalg.norm(post), param_share)
    else:
        post_mult_loss = zero

    # 3. mel reconstruction, per-frame normalised then batch-averaged
    diff = mel_preds - mel_tgt
    l1 = torch.sum(torch.abs(diff), dim=(1, 2)) / (n_mel * out_lens)
    l2 = torch.sum(diff * diff, dim=(1, 2)) / (n_mel * out_lens)
    mel_l1 = share(cfg['mel_spec_weight'] * torch.mean(l1), row_share)
    mel_l2 = share(cfg['mel_spec_weight'] * torch.mean(l2), row_share)

    loss = speaker_loss + post_mult_loss + mel_l1 + mel_l2

    # 4. energy consistency
    energy_loss = zero
    if cfg['energy_consistency_weight'] > 0:
        T = mel_preds.shape[-1]
        pred_e = torch.linalg.norm(torch.exp(mel_preds), dim=1)   # (B, T)
        tgt_e = torch.linalg.norm(torch.exp(mel_tgt), dim=1)
        mse = (_avg_pool5(pred_e) - _avg_pool5(tgt_e)) ** 2
        mask = torch.arange(T, device=mse.device)[None, :] < out_lens[:, None]
        energy_loss = torch.sum(mse * mask) / len_sum
        loss = loss + cfg['energy_consistency_weight'] * energy_loss

    # 5. pitch consistency (frozen predictor)
    pitch_loss = zero
    if pitch_on:
        pred_pitch = pitch_predictor(mel_preds)                    # (B, T)
        mse = (pred_pitch - gt) ** 2
        pitch_loss = torch.sum(mse * voiced) / (mask_sum + 1e-5)
        loss = loss + cfg['pitch_consistency_weight'] * pitch_loss

    individual = {
        'speaker_loss': speaker_loss,
        'speaker_ce_raw': ce_raw,
        'post_mult_loss': post_mult_loss,
        'mel_spec_l1_loss': mel_l1,
        'mel_spec_l2_loss': mel_l2,
        'energy_consistency_loss': energy_loss,
        'pitch_consistency_loss': pitch_loss,
    }
    return loss, individual


def loss_cfg_from_hparams(hp):
    return {
        'warmup_steps': float(getattr(hp, 'warmup_steps', 10000)),
        'adv_max_weight': float(getattr(hp, 'adv_max_weight', 1e-2)),
        'post_mult_weight': float(getattr(hp, 'post_mult_weight', 1e-3)),
        'mel_spec_weight': float(getattr(hp, 'mel_spec_weight', 1.0)),
        'energy_consistency_weight':
            float(getattr(hp, 'energy_consistency_weight', 0.0)),
        'pitch_consistency_weight':
            float(getattr(hp, 'pitch_consistency_weight', 0.0)),
        'n_mel_channels': float(hp.n_mel_channels),
    }
