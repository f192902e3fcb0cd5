"""Phoneme float-duration -> integer mel-frame duration quantization (copy
of ``daft_exprt_tpu/frontend/duration.py``: ``get_min_phone_duration``,
``duration_to_integer``).

Each phone's frame count is the number of analysis-window centers
p_i = filter_length/2 + hop*i strictly after its begin sample and at/before
its end sample, plus the HiFi-GAN edge-padding distribution for
center=False ((filter_length-hop)/hop extra frames split 1-left/2-right for
1024/256) and the centered variant.
"""


def get_min_phone_duration(lines, min_phone_dur=1000.0):
    """Shortest phone duration in a .markers line list (tab-separated
    begin/end)."""
    for line in lines:
        parts = line.strip().split(sep='\t')
        begin, end = float(parts[0]), float(parts[1])
        if end - begin < min_phone_dur:
            min_phone_dur = end - begin
    return min_phone_dur


def duration_to_integer(float_durations, hparams, nb_samples=None):
    """Quantize [begin, end] second intervals into integer frame counts.

    ``float_durations`` is consumed front-to-back (phones past the frame
    budget are left unconsumed); a phone with begin == end raises
    ValueError.
    """
    fl = hparams.filter_length
    hop = hparams.hop_length
    sr = hparams.sampling_rate

    if nb_samples is None:
        total_duration = sum(e - b for b, e in float_durations)
        nb_samples = int(total_duration * sr)
    nb_frames = 1 + int((nb_samples - fl) / hop)
    center = int(fl / 2)

    int_durations = []
    consumed = 0
    while consumed < nb_frames:
        begin, end = float_durations.pop(0)
        if begin == end:
            raise ValueError('zero-length phone duration')
        begin_s, end_s = int(begin * sr), int(end * sr)
        # frames with begin_s < center + hop*i <= end_s, i in [0, nb_frames)
        i_min = max((begin_s - center) // hop + 1, 0)
        i_max = min((end_s - center) // hop, nb_frames - 1)
        count = max(0, i_max - i_min + 1)
        int_durations.append(count)
        consumed += count

    if hparams.centered:
        nb_edge_frames = int(fl / 2 / hop)
        int_durations[0] += nb_edge_frames
        if len(float_durations) != 0:
            int_durations.append(nb_edge_frames)
        else:
            int_durations[-1] += nb_edge_frames
    else:
        # HiFi-GAN compatibility padding: (filter_length - hop)/hop extra
        # frames, distributed left-light/right-heavy
        extra_frames = int((fl - hop) / hop)
        left = extra_frames // 2
        right = extra_frames - left
        int_durations[0] += left
        if len(float_durations) != 0:
            int_durations.append(right)
        else:
            int_durations[-1] += right

    return int_durations
