"""Mean host time per batch of the window in the acoustic model's call
(``Synthesizer.infer``, which ends in a copy to the host): the
benchmark's span around the call."""


def read(record):
    if record.get('kind') != 'synth':
        return None
    items = record['items']
    return sum(it['t1'] - it['t0'] for it in items) / len(items) * 1e3
