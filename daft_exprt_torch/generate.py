"""Synthesis entry point (PyTorch port of ``daft_exprt_tpu/generate.py``'s
``Synthesizer`` and bucket padding): symbols + external prosody -> mels,
with the symbol and frame axes padded to the configured buckets and the
outputs cropped back to the batch's true length.
"""
import numpy as np
import torch


def _round_to_bucket(value, buckets):
    for b in buckets:
        if value <= b:
            return b
    # beyond the largest bucket: round up to a multiple of the last stride
    stride = buckets[-1] - buckets[-2] if len(buckets) > 1 else buckets[-1]
    return buckets[-1] + -(-(value - buckets[-1]) // stride) * stride


class Synthesizer:
    """Runs ``DaftExprt.inference`` on bucket-padded numpy batches on the
    model's device."""

    def __init__(self, model, hparams):
        self.model = model
        self.hparams = hparams
        self.device = next(model.parameters()).device

    def infer(self, symbols, duration_preds, durations_int, energy_preds,
              pitch_preds, input_lengths, spk_embs, accent_emb,
              bucket=True):
        """Pads to buckets, runs the model, returns numpy (mel, alignments,
        output_lengths) cropped to the true T_max."""
        hp = self.hparams
        B, L = symbols.shape
        output_lengths = durations_int.sum(axis=1).astype(np.int64)
        output_lengths[output_lengths == 0] = 1
        T_true = int(output_lengths.max())
        if bucket:
            L_pad = _round_to_bucket(L, hp.length_buckets)
            T_pad = _round_to_bucket(T_true, hp.frame_buckets)
        else:
            L_pad, T_pad = L, T_true

        def dev(x, n=None, dtype=None):
            x = np.asarray(x)
            if n is not None:
                x = np.pad(x, ((0, 0), (0, n - x.shape[1])))
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        out = self.model.inference(
            symbols=dev(symbols, L_pad, torch.long),
            duration_preds=dev(duration_preds, L_pad, torch.float32),
            durations_int=dev(durations_int, L_pad, torch.long),
            energy_preds=dev(energy_preds, L_pad, torch.float32),
            pitch_preds=dev(pitch_preds, L_pad, torch.float32),
            input_lengths=dev(input_lengths, dtype=torch.long),
            output_lengths=dev(output_lengths, dtype=torch.long),
            n_frames=T_pad,
            spk_embs=dev(spk_embs, dtype=torch.float32),
            accent_emb=dev(accent_emb, dtype=torch.float32))
        mel = out['mel_preds'][:, :, :T_true].float().cpu().numpy()
        weights = out['alignments'][:, :L, :T_true].float().cpu().numpy()
        return mel, weights, output_lengths
