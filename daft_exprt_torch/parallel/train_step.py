"""Training and evaluation steps (PyTorch port of
``daft_exprt_tpu/parallel/train_step.py``), on one device or data-parallel
over a mesh's data axis.

One step: forward with dropout, the composite loss, backward, gradient
accumulation over strided micro-batches (averaged), the global gradient
norm, clipping, and Adam with the warmup + inverse-sqrt schedule.

With a mesh, each rank runs the step on its local rows and the step
computes the JAX step's function over the global batch (one SPMD program
there): every loss term is this rank's share of the global term
(``compute_loss(group=...)``: global denominators), so the ranks' gradients
sum to the global gradient. They are summed once per step, after the
micro-batches, in one all-reduce of a flat buffer that also carries the
loss terms, as the JAX step reduces once after its scan; the reported
metrics are then the global ones on every rank. The micro-batch split stays
strided on each rank's rows: where the local batch divides by
``accumulation_steps``, the union of the ranks' micro-batch m is the JAX
step's global micro-batch m.
"""
import torch
import torch.distributed as dist
from torch.profiler import record_function

from daft_exprt_torch.loss import GLOBAL_STATS, compute_loss
from daft_exprt_torch.parallel.mesh import all_reduce_grads

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


RANK_STRIDE = 1 << 40       # past every (iteration, micro-batch) offset


def step_seed(seed, iteration, micro, rank=0):
    """The seed of the dropout generator of one micro-batch of one step on
    one data rank: each (seed, iteration, micro-batch, rank) has its own
    stream, as the JAX step folds the iteration and the micro-batch index
    into its key (and draws each global row's mask once); rank 0 keeps the
    single-process seed."""
    return (seed * 1_000_003 + int(iteration) * 7919 + micro
            + rank * RANK_STRIDE) % (2 ** 63)


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
                    accumulation_steps=1, grad_clip=float('inf'), mesh=None):
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
    :func:`step_seed` (seed, iteration, micro-batch, data rank).

    ``mesh`` (:func:`mesh.make_mesh`): data-parallel over its data axis
    (module note); ``batch`` and ``raw_frames`` are this rank's rows, the
    model and optimizer identical on every rank."""
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    n = accumulation_steps
    group = None if mesh is None else mesh.data_group
    rank = 0 if mesh is None else mesh.data_rank

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
                step_seed(seed, iteration, m, rank))
            with record_function('forward'):
                out = model(**micro[m], generator=gen)
                loss, indiv = compute_loss(
                    out, _targets(micro[m], micro_raw[m]), iteration,
                    loss_cfg, pitch_predictor, group=group)
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
            if group is not None:
                with record_function('all_reduce'):
                    loss_sum, = all_reduce_grads(params, [loss_sum], group)
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


def make_eval_step(model, loss_cfg, pitch_predictor=None, mesh=None):
    """Deterministic forward + loss for validation: eval_step(batch,
    raw_frames) -> (metrics, outputs). With a ``mesh``, ``batch`` holds
    this rank's rows and the metrics are those of the global batch (the
    ranks' rows together; one all-reduce of the terms), the outputs this
    rank's. A rank without rows while others have some (uneven validation
    shards) passes ``None`` for both and gets the others' global metrics
    and no outputs; when no rank has rows, every rank gets (None, None)."""
    group = None if mesh is None else mesh.data_group
    keys = ('loss',) + LOSS_TERMS
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch, raw_frames):
        if batch is None:
            stats = torch.zeros(len(GLOBAL_STATS), device=device)
            dist.all_reduce(stats, group=group)
            if not stats[0]:
                return None, None
            terms = torch.zeros(len(keys), device=device)
            dist.all_reduce(terms, group=group)
            return dict(zip(keys, terms.unbind())), None
        model.eval()
        out = model(**{k: batch[k] for k in MODEL_INPUT_KEYS})
        loss, indiv = compute_loss(out, _targets(batch, raw_frames), 0.0,
                                   loss_cfg, pitch_predictor, group=group)
        metrics = dict(indiv)
        metrics['loss'] = loss
        if group is not None:
            terms = torch.stack([metrics[k].float() for k in keys])
            dist.all_reduce(terms, group=group)
            metrics = dict(zip(keys, terms.unbind()))
        return metrics, out

    return eval_step


def to_device(batch, device):
    """numpy batch -> tensors on ``device`` (int64 stays int64, floats
    float32)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}

