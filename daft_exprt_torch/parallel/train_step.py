"""Training and evaluation steps on one device (PyTorch port of
``daft_exprt_tpu/parallel/train_step.py`` without the mesh; the sharded
multi-replica step is later work).

One step: forward with dropout, the composite loss, backward, gradient
accumulation over strided micro-batches (averaged), the global gradient
norm, clipping, and Adam with the warmup + inverse-sqrt schedule.
"""
import torch
from torch.profiler import record_function

from daft_exprt_torch.loss import compute_loss

MODEL_INPUT_KEYS = (
    'symbols', 'durations_float', 'durations_int', 'symbols_energy',
    'symbols_pitch', 'input_lengths', 'frames_energy', 'frames_pitch',
    'mel_specs', 'output_lengths', 'speaker_ids', 'spk_embs')
LOSS_TERMS = ('speaker_loss', 'speaker_ce_raw', 'post_mult_loss',
              'mel_spec_l1_loss', 'mel_spec_l2_loss',
              'energy_consistency_loss', 'pitch_consistency_loss')


def make_learning_rate_fn(hp):
    """Linear warmup then inverse-sqrt decay, as a function of the update
    count (a Python number)."""
    initial = hp.initial_learning_rate
    maximum = hp.max_learning_rate
    warmup = hp.warmup_steps

    def lr(iteration):
        iteration = float(iteration)
        if iteration < warmup:
            return (maximum - initial) / warmup * iteration + initial
        return (iteration if iteration > 0 else 1.0) ** -0.5 * maximum \
            / warmup ** -0.5

    return lr


class ScheduledAdam(torch.optim.Adam):
    """``torch.optim.Adam`` with ``weight_decay`` added to the gradient (the
    same as optax ``add_decayed_weights`` then ``scale_by_adam``) whose n-th
    update (n from 0, counted in ``updates``, which the state dict carries)
    takes the learning rate ``lr_fn(n)``, as optax's schedule reads its own
    count."""

    def __init__(self, params, hp):
        self.lr_fn = make_learning_rate_fn(hp)
        super().__init__(params, lr=self.lr_fn(0), betas=tuple(hp.betas),
                         eps=hp.epsilon, weight_decay=hp.weight_decay or 0.0)
        self.updates = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group['lr'] = self.lr_fn(self.updates)
        out = super().step(closure)
        self.updates += 1
        return out

    def state_dict(self):
        state = super().state_dict()
        state['updates'] = self.updates
        return state

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.updates = int(state_dict.pop('updates'))
        super().load_state_dict(state_dict)


def make_optimizer(model, hp):
    """Adam with weight decay in the gradient and the LR schedule, over the
    model's parameters."""
    return ScheduledAdam(model.parameters(), hp)


def step_seed(seed, iteration, micro):
    """The seed of the dropout generator of one micro-batch of one step:
    each (seed, iteration, micro-batch) has its own stream, as the JAX step
    folds the iteration and the micro-batch index into its key."""
    return (seed * 1_000_003 + int(iteration) * 7919 + micro) % (2 ** 63)


def _targets(micro, raw):
    return {'mel_specs': micro['mel_specs'],
            'output_lengths': micro['output_lengths'],
            'speaker_ids': micro['speaker_ids'],
            'frames_energy_raw': raw['frames_energy'],
            'frames_pitch_raw': raw['frames_pitch']}


def _split(x, n):
    """Strided micro-batch split: micro-batch m takes rows m, m + n, ..."""
    return [x[m::n] for m in range(n)]


def make_train_step(model, optimizer, loss_cfg, pitch_predictor=None,
                    accumulation_steps=1, grad_clip=float('inf')):
    """Returns train_step(batch, raw_frames, iteration, seed) -> metrics
    (a dict of float32 tensors on the model's device: loss, each loss term,
    grad_norm); it updates the model and the optimizer in place. Its
    phases run in the profiler ranges 'forward' (with the loss),
    'backward' and 'optimizer' (norm, clip and update).

    ``batch`` holds the normalised model inputs, ``raw_frames`` the
    pre-normalisation frame prosody of the consistency losses, both as
    tensors on the model's device. With accumulation_steps > 1 the batch
    must divide into that many strided micro-batches; their gradients and
    losses are averaged. Each micro-batch draws its dropout masks from its
    own ``torch.Generator`` on the model's device, seeded by
    :func:`step_seed` (seed, iteration, micro-batch)."""
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    n = accumulation_steps

    def train_step(batch, raw_frames, iteration, seed):
        model.train()
        for p in params:
            p.grad = None
        micro = [{k: v for k, v in zip(MODEL_INPUT_KEYS, vals)} for vals in
                 zip(*(_split(batch[k], n) for k in MODEL_INPUT_KEYS))]
        micro_raw = [dict(zip(('frames_energy', 'frames_pitch'), vals))
                     for vals in zip(_split(raw_frames['frames_energy'], n),
                                     _split(raw_frames['frames_pitch'], n))]
        loss_sum = None
        for m in range(n):
            gen = torch.Generator(device).manual_seed(
                step_seed(seed, iteration, m))
            with record_function('forward'):
                out = model(**micro[m], generator=gen)
                loss, indiv = compute_loss(
                    out, _targets(micro[m], micro_raw[m]), iteration,
                    loss_cfg, pitch_predictor)
            with record_function('backward'):
                (loss / n).backward()
            terms = torch.stack([loss.detach()] +
                                [indiv[k].detach() for k in LOSS_TERMS])
            loss_sum = terms if loss_sum is None else loss_sum + terms
        loss_sum = loss_sum / n
        with record_function('optimizer'):
            for p in params:
                if p.grad is None:          # unused here: a zero gradient
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if grad_clip != float('inf'):
                factor = torch.clamp(grad_clip / (grad_norm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, factor)
            optimizer.step()
        metrics = dict(zip(('loss',) + LOSS_TERMS, loss_sum.unbind()))
        metrics['grad_norm'] = grad_norm
        return metrics

    return train_step


def make_eval_step(model, loss_cfg, pitch_predictor=None):
    """Deterministic forward + loss for validation: eval_step(batch,
    raw_frames) -> (metrics, outputs)."""

    @torch.no_grad()
    def eval_step(batch, raw_frames):
        model.eval()
        out = model(**{k: batch[k] for k in MODEL_INPUT_KEYS})
        loss, indiv = compute_loss(out, _targets(batch, raw_frames), 0.0,
                                   loss_cfg, pitch_predictor)
        metrics = dict(indiv)
        metrics['loss'] = loss
        return metrics, out

    return eval_step


def to_device(batch, device):
    """numpy batch -> tensors on ``device`` (int64 stays int64, floats
    float32)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}

